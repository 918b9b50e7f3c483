"""Texture accumulation (port of ``jafpro_tpu/models/accumulate.py:26-107``,
the level-major form): a per-part U-Net whose five skip levels are fused
across the N reference atlases by grouped ConvLSTMs."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jafpro_tpu_torch.models.conv_lstm import GroupedConvLSTM
from jafpro_tpu_torch.models.parts import (
    ENC_NC, PartDecoder, PartEncoder, pack_parts, unpack_parts)


class AccumulateLSTM(nn.Module):
    """(B, N, P, h, w, 3) reference part stacks + (B, N) reference mask ->
    fused texture parts (B, P, h, w, 3)."""

    def __init__(self, parts: int = 24, compute_dtype=None):
        super().__init__()
        self.parts = parts
        self.PartEncoder_0 = PartEncoder(parts, compute_dtype=compute_dtype)
        for level in range(5):
            c = ENC_NC[2 * level]
            self.add_module(f"lstm{level}", GroupedConvLSTM(
                parts, c, c, compute_dtype=compute_dtype))
        self.PartDecoder_0 = PartDecoder(parts, compute_dtype=compute_dtype)

    def forward(self, parts: torch.Tensor,
                ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, P, H, W, C = parts.shape
        if P != self.parts:
            raise ValueError(f"expected {self.parts} parts, got {P}")
        if ref_mask is None:
            ref_mask = parts.new_ones((B, N))
        skips = self.PartEncoder_0(
            pack_parts(parts.reshape(B * N, P, H, W, C)))
        fused = []
        for level, s in enumerate(skips):
            seq = s.reshape(B, N, *s.shape[1:])
            fused.append(getattr(self, f"lstm{level}")(seq, ref_mask))
        return unpack_parts(self.PartDecoder_0(tuple(fused)), P)
