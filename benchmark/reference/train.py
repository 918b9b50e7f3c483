"""Training stage 4 as the reference computes it: one generator forward
per step; the face discriminator takes 1 Adam update and the image
discriminator 3 on the detached output; then the generator's loss (VGG19
perceptual + L1, 2 x the image GAN term, 2 x the face GAN term on a detached
face crop) is taken with the updated discriminators and back through the
saved forward into accu, inpaint, refine and pro. The background CRN is
frozen and the SMPL flow has no parameters: both run without a graph.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference.generate import expand, nchw, nhwc, textures

LRS = {"accu": 1e-5, "inpaint": 1e-5, "refine": 1e-5, "pro": 5e-5,
       "D": 3e-6, "FD": 1e-6}
GEN_MODULES = ("accu", "inpaint", "refine", "pro")
VGG_WEIGHTS = (1 / 2.6, 1 / 4.8, 1 / 3.7, 1 / 5.6, 10 / 1.5)
CAFFE_MEANS = (103.939, 116.779, 123.68)


def bce(pred, target, eps=1e-7):
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def bce_mean(pred, target):
    return bce(pred, target).mean()


def bce_valid(pred, target, valid):
    """Mean over the samples with a face box only."""
    per = bce(pred, target).reshape(pred.shape[0], -1).mean(dim=1)
    v = valid.float()
    return torch.sum(per * v) / torch.clamp(torch.sum(v), min=1.0)


def l1(x, y):
    return torch.mean(torch.abs(x - y))


def vgg_l1(vgg, x, y):
    means = torch.tensor(CAFFE_MEANS, device=x.device)
    xp = 255.0 * (x + 1.0) / 2.0 - means
    yp = 255.0 * (y + 1.0) / 2.0 - means
    fx = vgg(nchw(xp))
    with torch.no_grad():
        fy = vgg(nchw(yp))
    return sum(w * l1(a, b) for w, a, b in zip(VGG_WEIGHTS, fx, fy)) + l1(
        xp, yp)


def crop_faces(images, bbox, size, mode="bilinear"):
    """(B, H, W, C) -> (B, size, size, C): each (x0, x1, y0, y1) box
    resampled at pixel centres, border padded."""
    B = images.shape[0]
    x0, x1, y0, y1 = bbox.unbind(-1)
    t = (torch.arange(size, dtype=images.dtype, device=images.device)
         + 0.5) / size
    xs = x0[:, None] + t[None] * (x1 - x0)[:, None] - 0.5
    ys = y0[:, None] + t[None] * (y1 - y0)[:, None] - 0.5
    grid = torch.stack([xs[:, None, :].expand(B, size, size),
                        ys[:, :, None].expand(B, size, size)], -1)
    return nhwc(ops.grid_sample(nchw(images), grid, "border", mode,
                                pixel_coords=True))


class Stage4:
    """The step's state: the bundle and one Adam per trained module.
    ``apply=False`` forms every gradient and applies none (the FLOP
    count)."""

    def __init__(self, net, faces: torch.Tensor, cfg: dict,
                 apply: bool = True):
        self.net, self.faces, self.cfg, self.apply = net, faces, cfg, apply
        self.params = {n: list(getattr(net, n).parameters()) for n in LRS}
        self.opts = {n: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999),
                                         eps=1e-8)
                     for (n, ps), lr in zip(self.params.items(),
                                            LRS.values())}

    def _update(self, loss, names: Sequence[str]) -> None:
        flat = [p for n in names for p in self.params[n]]
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        if not self.apply:
            return
        for p, g in zip(flat, gs):
            p.grad = torch.zeros_like(p) if g is None else g
        for n in names:
            self.opts[n].step()
            self.opts[n].zero_grad(set_to_none=True)

    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        net, cfg = self.net, self.cfg
        b = expand(batch, self.faces.device)
        S, fs = cfg["image_size"], cfg["face_crop_size"]
        with torch.no_grad():
            tsf = ops.smpl_flow_warp(
                nchw(b["prev_img"]), b["prev_cam"], b["prev_verts"],
                b["tgt_cam"], b["tgt_verts"], self.faces, S, cfg["near"],
                cfg["far"], cfg["viewing_angle"])
            bg = net.bg(nchw(b["bg_incomplete"]), S)
        inpainted = textures(net, b["src_parts"], b["src_mask_parts"],
                             b["ref_mask"])
        warped = ops.texture_warp_atlas(ops.parts_to_atlas(inpainted),
                                        b["tgt_iuv255"])
        refined, fg = net.refine(nchw(warped), S)
        fusion = refined * fg + bg * (1.0 - fg)
        final = nhwc(net.pro(fusion, tsf, nchw(b["tgt_iuv"]),
                             nchw(b["smpl_mask"]),
                             per_sample_norm=False)["pred_target"])
        fake = final.detach()
        bbox = b["face_bbox"]
        valid = bbox[:, 1] > bbox[:, 0]
        face_real = crop_faces(b["tgt_img"], bbox, fs)
        face_fake = crop_faces(fake, bbox, fs)
        face_iuv = crop_faces(b["tgt_iuv"], bbox, fs, mode="nearest")
        B = fake.shape[0]
        ones = torch.ones((B, 1), device=fake.device)
        zeros = torch.zeros((B, 1), device=fake.device)

        def prob(d, *images):
            return d(nchw(torch.cat(images, dim=-1)))

        fd = bce_valid(prob(net.FD, face_real, face_iuv), ones, valid) + \
            bce_valid(prob(net.FD, face_fake, face_iuv), zeros, valid)
        self._update(fd, ("FD",))
        for _ in range(3):
            d = bce_mean(prob(net.D, b["tgt_img"], b["src_img_first"]),
                         ones) + bce_mean(
                prob(net.D, fake, b["src_img_first"]), zeros)
            self._update(d, ("D",))
        recon = vgg_l1(net.vgg, final, b["tgt_img"])
        err_g = bce_mean(prob(net.D, final, b["src_img_first"]), ones)
        f_err_g = bce_valid(prob(net.FD, crop_faces(final, bbox, fs).detach(),
                                 face_iuv), ones, valid)
        total = recon + 2.0 * err_g + 2.0 * f_err_g
        self._update(total, GEN_MODULES)
        return {k: v.detach() for k, v in (
            ("FD", fd), ("D", d), ("loss", total), ("recon", recon),
            ("G", err_g), ("FG", f_err_g))}
