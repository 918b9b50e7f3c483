"""The end-to-end generator (port of ``jafpro_tpu/pipeline.py``).

  accumulate (ConvLSTM fusion over refs)
    -> mask by the union of reference visibility
    -> inpaint (global-bottleneck 24-part U-Net)
    -> texture warp through the target IUV
    -> CRN foreground refine (+ soft mask)
    -> fuse with the CRN background
    -> SMPL-flow warp of the nearest reference frame
    -> propagation blend

The modules hold their parameters (initialised from a seeded
``torch.Generator``, or loaded from a JAX param tree with
``bridge.load_jax_params``). The methods take and return the JAX
package's channels-last layouts; the nets run NCHW inside. Training adds
the image and face discriminators and the frozen VGG19 of the perceptual
loss (``D``, ``FD``, ``vgg``), and ``crop_faces`` for the face GAN.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.data.texture import parts_to_atlas, texture_warp_atlas
from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.models import (
    AccumulateLSTM, CRNSmaller, Propagation3DFlowNet, UNetInpainter)
from jafpro_tpu_torch.models.common import init_params_
from jafpro_tpu_torch.models.discriminators import (
    FaceDiscriminator, ImageDiscriminator)
from jafpro_tpu_torch.models.vgg import VGG19Features
from jafpro_tpu_torch.ops.sampling import grid_sample


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class JAFProPipeline(nn.Module):
    """Module bundle under the JAX package's param-tree names: ``accu``,
    ``inpaint``, ``bg``, ``refine``, ``pro``, ``D``, ``FD``, ``vgg`` (the
    last frozen: its parameters need no gradient)."""

    def __init__(self, cfg: Config, flow_engine: Optional[SMPLFlowEngine] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        cd = getattr(torch, cfg.compute_dtype)
        P = cfg.num_parts
        self.accu = AccumulateLSTM(P, compute_dtype=cd)
        self.inpaint = UNetInpainter(P, compute_dtype=cd)
        self.bg = CRNSmaller(fg=False, compute_dtype=cd)
        self.refine = CRNSmaller(fg=True, compute_dtype=cd)
        self.pro = Propagation3DFlowNet(compute_dtype=cd)
        self.D = ImageDiscriminator(cfg.image_size, compute_dtype=cd)
        self.FD = FaceDiscriminator(cfg.face_crop_size, compute_dtype=cd)
        self.vgg = VGG19Features(compute_dtype=cd)
        self.vgg.requires_grad_(False)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params_(self, generator)
        self.to(self.device)
        if flow_engine is None and cfg.num_faces:
            try:
                flow_engine = SMPLFlowEngine.create(
                    image_size=cfg.image_size, near=cfg.near, far=cfg.far,
                    viewing_angle=cfg.viewing_angle)
            except FileNotFoundError:
                flow_engine = None
        self.flow_engine = flow_engine

    def prepare_textures(self, src_parts: torch.Tensor, ref_mask: torch.Tensor,
                         src_mask_parts: torch.Tensor):
        """Accumulate + union-mask + inpaint. src_parts (B, N, P, p, p, 3),
        ref_mask (B, N), src_mask_parts (B, N, P, p, p) ->
        (inpainted parts (B, P, p, p, 3), union mask (B, P, p, p))."""
        accu_parts = self.accu(src_parts, ref_mask)
        masked = src_mask_parts * ref_mask[:, :, None, None, None]
        union = masked.amax(dim=1)
        accu_parts = accu_parts * union[..., None]
        return self.inpaint(accu_parts), union

    def background(self, bg_incomplete: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, S, S, 3)."""
        return to_nhwc(self.bg(to_nchw(bg_incomplete), self.cfg.image_size))

    def generate_frame(self, inpainted_parts, bg_output, tgt_iuv255, tgt_iuv,
                       smpl_mask, prev_img, prev_cam, prev_verts, tgt_cam,
                       tgt_verts, tsf=None) -> Dict[str, torch.Tensor]:
        """One batch of frames, channels-last in and out (see the JAX
        ``generate_frame``). The SMPL flow has no trainable parameters
        upstream, so it runs without a graph; a trainer that has computed
        it already passes it as ``tsf`` (B, S, S, 3)."""
        S = self.cfg.image_size
        warped = texture_warp_atlas(parts_to_atlas(inpainted_parts),
                                    tgt_iuv255)
        refined, fg_mask = self.refine(to_nchw(warped), S)
        fusion = refined * fg_mask + to_nchw(bg_output) * (1.0 - fg_mask)
        if tsf is None:
            with torch.no_grad():
                tsf_c = self.flow_engine(to_nchw(prev_img), prev_cam,
                                         prev_verts, tgt_cam, tgt_verts)
        else:
            tsf_c = to_nchw(tsf)
        out = self.pro(fusion, tsf_c, to_nchw(tgt_iuv), to_nchw(smpl_mask))
        return {
            "final": to_nhwc(out["pred_target"]),
            "weight": to_nhwc(out["weight"]),
            "fusion": to_nhwc(fusion),
            "refined": to_nhwc(refined),
            "fg_mask": to_nhwc(fg_mask),
            "tsf": to_nhwc(tsf_c),
            "warped": warped,
        }


def crop_faces(images: torch.Tensor, bbox: torch.Tensor, out_size: int = 64,
               mode: str = "bilinear") -> torch.Tensor:
    """Fixed-size face crop: resample each bbox region of (B, H, W, C)
    ``images`` to (B, out, out, C) with a border-padded ``grid_sample``
    (the reference slices and upsamples, ``train/4:334-353``). bbox
    (B, 4) = (x0, x1, y0, y1) pixel coords. The sample positions go to
    ``grid_sample`` in pixel coords: the JAX package normalizes them to
    [-1, 1] and ``grid_sample`` maps them back, a round trip its compiler
    folds away, so this is the arithmetic of its compiled step (a box on
    half pixels rounds the same way in ``mode="nearest"``)."""
    B = images.shape[0]
    x0, x1, y0, y1 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    t = (torch.arange(out_size, dtype=images.dtype, device=images.device)
         + 0.5) / out_size
    xs = x0[:, None] + t[None] * (x1 - x0)[:, None] - 0.5
    ys = y0[:, None] + t[None] * (y1 - y0)[:, None] - 0.5
    grid = torch.stack(
        [xs[:, None, :].expand(B, out_size, out_size),
         ys[:, :, None].expand(B, out_size, out_size)], dim=-1)
    return to_nhwc(grid_sample(to_nchw(images), grid, padding_mode="border",
                               mode=mode, pixel_coords=True))
