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
package's channels-last layouts; the nets run NCHW inside.
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


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class JAFProPipeline(nn.Module):
    """Module bundle under the JAX package's param-tree names: ``accu``,
    ``inpaint``, ``bg``, ``refine``, ``pro``."""

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
                       tgt_verts) -> Dict[str, torch.Tensor]:
        """One batch of frames, channels-last in and out (see the JAX
        ``generate_frame``)."""
        S = self.cfg.image_size
        warped = texture_warp_atlas(parts_to_atlas(inpainted_parts),
                                    tgt_iuv255)
        refined, fg_mask = self.refine(to_nchw(warped), S)
        fusion = refined * fg_mask + to_nchw(bg_output) * (1.0 - fg_mask)
        tsf_c = self.flow_engine(to_nchw(prev_img), prev_cam, prev_verts,
                                 tgt_cam, tgt_verts)
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
