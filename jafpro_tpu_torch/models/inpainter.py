"""Texture inpainting (port of ``jafpro_tpu/models/inpainter.py:26-49``):
24 per-part U-Nets sharing a global bottleneck code."""

from __future__ import annotations

import torch
from torch import nn

from jafpro_tpu_torch.models.parts import (
    ENC_NC, GroupConvLReLU, PartDecoder, PartEncoder, pack_parts,
    unpack_parts)


class UNetInpainter(nn.Module):
    """(B, P, h, w, 3) fused-texture parts -> inpainted parts (same shape)."""

    def __init__(self, num_parts: int = 24, compute_dtype=None):
        super().__init__()
        P = num_parts
        self.num_parts = P
        self.PartEncoder_0 = PartEncoder(P, compute_dtype=compute_dtype)
        # per-part 96 -> 3 compress
        self.GroupConvLReLU_0 = GroupConvLReLU(P, [ENC_NC[8]], 3,
                                               compute_dtype=compute_dtype)
        # decoder bottleneck per part: [x9 (96), global code (P*3)]
        self.PartDecoder_0 = PartDecoder(
            P, dec_nc=(96, 48, 24, 12), bottleneck_cins=(P * 3,),
            compute_dtype=compute_dtype)

    def forward(self, parts: torch.Tensor) -> torch.Tensor:
        P = parts.shape[1]
        if P != self.num_parts:
            raise ValueError(f"expected {self.num_parts} parts, got {P}")
        skips = self.PartEncoder_0(pack_parts(parts))
        embed = self.GroupConvLReLU_0(skips[-1])      # (B, P*3, 13, 13)
        # global code: every part's embedding, given to every part
        ge = embed.repeat(1, P, 1, 1)                 # (B, P*(P*3), 13, 13)
        return unpack_parts(self.PartDecoder_0(skips, bottleneck=[ge]), P)
