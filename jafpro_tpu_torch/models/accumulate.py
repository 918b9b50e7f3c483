"""Texture accumulation (port of ``jafpro_tpu/models/accumulate.py``): a
per-part U-Net whose five skip levels are fused across the N reference
atlases by recurrences. ``AccumulateLSTM`` (the level-major form, the
pipeline's) fuses by grouped ConvLSTMs; the ablation ``AccumulateGRU`` by
ConvGRUs or ModGRUs."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jafpro_tpu_torch.models.common import mark_vmapped, place
from jafpro_tpu_torch.models.conv_lstm import ConvGRU, GroupedConvLSTM
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


class _PartGRU(nn.Module):
    """The P one-part networks of ``AccumulateGRU`` as one grouped network:
    encoder, a ConvGRU per skip level over the references, decoder."""

    def __init__(self, parts: int, cell: str, compute_dtype=None):
        super().__init__()
        self.PartEncoder_0 = PartEncoder(parts, compute_dtype=compute_dtype)
        for level in range(5):
            c = ENC_NC[2 * level]
            self.add_module(f"gru{level}", ConvGRU(
                c, c, cell=cell, compute_dtype=compute_dtype, parts=parts,
                device=None))
        self.PartDecoder_0 = PartDecoder(parts, compute_dtype=compute_dtype)
        mark_vmapped(self, parts)
        mark_vmapped(self.PartEncoder_0, parts, part_axis=True)
        mark_vmapped(self.PartDecoder_0, parts, part_axis=True)

    def forward(self, x: torch.Tensor, B: int, N: int,
                mask: torch.Tensor) -> torch.Tensor:
        fused = []
        for level, s in enumerate(self.PartEncoder_0(x)):
            _, h = getattr(self, f"gru{level}")(
                s.reshape(B, N, *s.shape[1:]), mask)
            fused.append(h)
        return self.PartDecoder_0(tuple(fused))


class AccumulateGRU(nn.Module):
    """Ablation: reference fusion by ConvGRU (``cell="gru"``) or ModGRU
    (``"modgru"``) instead of ConvLSTM; the interface of
    ``AccumulateLSTM``. flax vmaps one-part networks over the parts with
    their parameters stacked on a leading axis (``Vmap_PartGRU_0``); here
    they run as one grouped network, and ``bridge.py`` concatenates the
    stacked leaves. Built on ``device`` (the card unless the caller asks
    for the CPU) from ``generator``."""

    def __init__(self, parts: int = 24, cell: str = "gru",
                 compute_dtype=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.parts = parts
        self.Vmap_PartGRU_0 = _PartGRU(parts, cell, compute_dtype)
        place(self, device, generator)

    def forward(self, parts: torch.Tensor,
                ref_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, P, H, W, C = parts.shape
        if P != self.parts:
            raise ValueError(f"expected {self.parts} parts, got {P}")
        if ref_mask is None:
            ref_mask = parts.new_ones((B, N))
        x = pack_parts(parts.reshape(B * N, P, H, W, C))
        return unpack_parts(self.Vmap_PartGRU_0(x, B, N, ref_mask), P)
