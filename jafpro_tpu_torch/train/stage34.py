"""Stages 3 and 4: the adversarial image stages (port of
``jafpro_tpu/train/stage34.py``, its single-forward ``"vjp"`` form).

Stage 3 (reference ``train/3.inpaint_global_convLSTM_FGAN.py``): the image
path without propagation. Trains accu/inpaint/bg/refine at 1e-4, image D
and face D at 3e-6 with 3 updates each per step; the G loss is
VGG_l1(final, target) + 2 errG + 2 F_errG.

Stage 4 (reference ``train/4.convLSTM_flowpro_interval.py``): adds the
SMPL-flow propagation; bg is frozen and runs without a graph; accu,
inpaint and refine at 1e-5, propagation 5e-5, D 3e-6 (3 updates), face D
1e-6 (1 update). The flow ``tsf`` has no parameters upstream: it is
rasterized once per step without a graph (the CUDA kernel on the card).

One generator forward per step: its detached output trains the
discriminators, then the G loss runs D and FD with their updated weights
and backpropagates through the saved generator graph (the reference
reuses one forward's graph the same way, ``train/4:396-408``). Only the
generator modules' optimizers step on that backward; the discriminators'
gradients from the G loss are never formed. The stage-4 face term is
computed on a detached crop (``train/4:399``), the stage-3 one is not
(``train/3:365``).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import torch

from jafpro_tpu_torch.data.texture import parts_to_atlas, texture_warp_atlas
from jafpro_tpu_torch.losses import bce, bce_masked, vgg_l1_loss
from jafpro_tpu_torch.pipeline import crop_faces, to_nchw, to_nhwc
from jafpro_tpu_torch.train.common import TrainState, normalize_batch
from jafpro_tpu_torch.utils.profiling import span


def stage3_lrs():
    return {"accu": 1e-4, "inpaint": 1e-4, "bg": 1e-4, "refine": 1e-4,
            "D": 3e-6, "FD": 3e-6}


def stage4_lrs():
    return {"accu": 1e-5, "inpaint": 1e-5, "refine": 1e-5, "pro": 5e-5,
            "D": 3e-6, "FD": 1e-6}


def _generator_forward(pipe, batch, *, with_propagation: bool, tsf=None):
    """The generator's output image (B, S, S, 3), with its graph."""
    inpainted, _ = pipe.prepare_textures(
        batch["src_parts"], batch["ref_mask"], batch["src_mask_parts"])
    if not with_propagation:
        bg_out = pipe.background(batch["bg_incomplete"])
        warped = texture_warp_atlas(parts_to_atlas(inpainted),
                                    batch["tgt_iuv255"])
        refined, fg = pipe.refine(to_nchw(warped), pipe.cfg.image_size)
        return to_nhwc(refined * fg + to_nchw(bg_out) * (1.0 - fg))
    with torch.no_grad():
        bg_out = pipe.background(batch["bg_incomplete"])
    out = pipe.generate_frame(
        inpainted, bg_out, batch["tgt_iuv255"], batch["tgt_iuv"],
        batch["smpl_mask"], batch["prev_img"], batch["prev_cam"],
        batch["prev_verts"], batch["tgt_cam"], batch["tgt_verts"], tsf)
    return out["final"]


def _make_gan_step(pipe, *, with_propagation: bool,
                   gen_modules: Tuple[str, ...], face_d_steps: int,
                   img_d_steps: int, detach_face_g: bool):
    face_gan = pipe.cfg.face_GAN
    face_size = pipe.cfg.face_crop_size
    if not face_gan:
        # the reference's face_GAN option off: no face-D updates and no
        # face term in the G loss (train/4:357-374)
        face_d_steps = 0

    def d_prob(net, *images):
        return net(to_nchw(torch.cat(images, dim=-1)))

    def g_loss_tail(final, batch, face_iuv, face_valid):
        recon = vgg_l1_loss(pipe.vgg, final, batch["tgt_img"])
        ones = torch.ones((final.shape[0], 1), dtype=final.dtype,
                          device=final.device)
        err_g = bce(d_prob(pipe.D, final, batch["src_img_first"]), ones)
        if face_gan:
            face_pred = crop_faces(final, batch["face_bbox"], face_size)
            if detach_face_g:
                face_pred = face_pred.detach()
            # samples without face pixels drop out (the reference skips them)
            f_err_g = bce_masked(d_prob(pipe.FD, face_pred, face_iuv), ones,
                                 face_valid)
        else:
            f_err_g = torch.zeros((), dtype=final.dtype, device=final.device)
        total = recon + 2.0 * err_g + 2.0 * f_err_g
        return total, {"loss": total, "recon": recon, "G": err_g,
                       "FG": f_err_g}

    iterations = itertools.count()

    def step(state: TrainState, batch):
        with span("train.step", device=True, item=next(iterations)):
            return step_body(state, batch)

    def step_body(state: TrainState, batch):
        batch = normalize_batch(batch)
        tsf = None
        if with_propagation:
            with span("train.flow", device=True), torch.no_grad():
                tsf = to_nhwc(pipe.flow_engine(
                    to_nchw(batch["prev_img"]), batch["prev_cam"],
                    batch["prev_verts"], batch["tgt_cam"],
                    batch["tgt_verts"]))

        # ---- the generator forward, once, and the crops of its output
        # that the discriminators take ----
        with span("train.gen_forward", device=True):
            final = _generator_forward(pipe, batch,
                                       with_propagation=with_propagation,
                                       tsf=tsf)
            fake = final.detach()
            bbox = batch["face_bbox"]
            face_valid = bbox[:, 1] > bbox[:, 0]
            face_real = crop_faces(batch["tgt_img"], bbox, face_size)
            face_fake = crop_faces(fake, bbox, face_size)
            face_iuv = crop_faces(batch["tgt_iuv"], bbox, face_size,
                                  mode="nearest")
            B = fake.shape[0]
            ones = torch.ones((B, 1), dtype=fake.dtype, device=fake.device)
            zeros = torch.zeros((B, 1), dtype=fake.dtype, device=fake.device)
        metrics = {}

        # ---- face discriminator ----
        fd_val = torch.zeros((), device=fake.device)
        for _ in range(face_d_steps):
            with span("train.fd", device=True):
                fd_val = bce_masked(d_prob(pipe.FD, face_real, face_iuv),
                                    ones, face_valid) + bce_masked(
                    d_prob(pipe.FD, face_fake, face_iuv), zeros, face_valid)
                state.apply_gradients(state.grads(fd_val, ("FD",)))
        metrics["FD"] = fd_val.detach()

        # ---- image discriminator ----
        d_val = torch.zeros((), device=fake.device)
        for _ in range(img_d_steps):
            with span("train.d", device=True):
                d_val = bce(d_prob(pipe.D, batch["tgt_img"],
                                   batch["src_img_first"]), ones) + bce(
                    d_prob(pipe.D, fake, batch["src_img_first"]), zeros)
                state.apply_gradients(state.grads(d_val, ("D",)))
        metrics["D"] = d_val.detach()

        # ---- generator: the tail with the updated D and FD, then back
        # through the saved generator graph ----
        with span("train.g_loss", device=True):
            total, g_metrics = g_loss_tail(final, batch, face_iuv,
                                           face_valid)
        state.apply_gradients(state.grads(total, gen_modules))
        metrics.update({k: v.detach() for k, v in g_metrics.items()})
        return state, metrics

    return step


def make_stage3_step(pipe):
    return _make_gan_step(
        pipe, with_propagation=False,
        gen_modules=("accu", "inpaint", "bg", "refine"),
        face_d_steps=3, img_d_steps=3, detach_face_g=False)


def make_stage4_step(pipe):
    return _make_gan_step(
        pipe, with_propagation=True,
        gen_modules=("accu", "inpaint", "refine", "pro"),
        face_d_steps=1, img_d_steps=3, detach_face_g=True)
