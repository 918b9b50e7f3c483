"""Cascaded refinement networks (port of ``jafpro_tpu/models/crn.py``),
NCHW.

A 6-level avg-pool encoder and a coarse-to-fine decoder where each level
takes [bilinearly resized input label, encoder skip, upsampled previous
decode]. ``fg=True`` adds the sigmoid mask head of the foreground refiner.
``CRN``, ``CRNSmall`` and ``CRNSmaller`` differ only in the encoder's
repeats and widths; ``CRNSmaller`` is the size the pipeline runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from jafpro_tpu_torch.models.common import Conv2d, ConvBlock, place
from jafpro_tpu_torch.ops.image import avg_pool_3x3s2
from jafpro_tpu_torch.ops.sampling import resize_bilinear


class _CRNBase(nn.Module):
    """label (B, C, sp, sp) -> (B, 3, sp, sp) [, fg mask (B, 1, sp, sp)]."""

    ENC_REPEATS: Sequence[int] = ()
    ENC_NC: Sequence[int] = ()

    def __init__(self, fg: bool = False, cin: int = 3,
                 enc_repeats: Optional[Sequence[int]] = None,
                 enc_nc: Optional[Sequence[int]] = None,
                 compute_dtype=None):
        super().__init__()
        enc_repeats = tuple(enc_repeats or self.ENC_REPEATS)
        enc_nc = tuple(enc_nc or self.ENC_NC)
        self.fg = fg
        self.enc_nc = enc_nc
        n = 0
        c = cin
        for r, f in zip(enc_repeats, enc_nc):
            self.add_module(f"ConvBlock_{n}", ConvBlock(
                r, c, f, compute_dtype=compute_dtype))
            c = f
            n += 1
        prev = 0
        for lvl in range(6, 0, -1):  # decoder levels 6..1
            feat = 512 if lvl > 1 else 256
            self.add_module(f"ConvBlock_{n}", ConvBlock(
                2, cin + enc_nc[lvl - 1] + prev, feat,
                compute_dtype=compute_dtype))
            prev = feat
            n += 1
        self.add_module(f"ConvBlock_{n}", ConvBlock(
            2, cin + prev, 256, compute_dtype=compute_dtype))
        self.n_blocks = n + 1
        self.Conv_0 = Conv2d(256, 3, 1, compute_dtype=compute_dtype)
        if fg:
            self.Conv_1 = Conv2d(256, 1, 1, compute_dtype=compute_dtype)

    def forward(self, label: torch.Tensor, sp: int):
        pools = []
        x = label
        for i in range(len(self.enc_nc)):
            x = avg_pool_3x3s2(getattr(self, f"ConvBlock_{i}")(x))
            pools.append(x)
        net = None
        n = len(self.enc_nc)
        for lvl in range(6, 0, -1):
            # clamp to 1px so sub-64 sizes stay well-formed
            size = max(1, sp // (2 ** lvl))
            down = resize_bilinear(label, (size, size), align_corners=True)
            feats = [down, pools[lvl - 1]] + ([] if net is None else [net])
            x = getattr(self, f"ConvBlock_{n}")(torch.cat(feats, dim=1))
            n += 1
            up = max(1, sp // (2 ** (lvl - 1)))
            net = resize_bilinear(x, (up, up), align_corners=True)
        net = getattr(self, f"ConvBlock_{n}")(torch.cat([label, net], dim=1))
        out = self.Conv_0(net)
        if self.fg:
            return out, torch.sigmoid(self.Conv_1(net))
        return out


class CRNSmaller(_CRNBase):
    """The size the pipeline runs, for both the refiner and the
    background; built unplaced, for the pipeline to initialise."""

    ENC_REPEATS = (2, 2, 2, 2, 2, 2)
    ENC_NC = (64, 128, 128, 256, 256, 512)


class CRN(_CRNBase):
    """The reference's full-size CRN; built on ``device`` (the card unless
    the caller asks for the CPU) from ``generator``."""

    ENC_REPEATS = (2, 2, 3, 3, 3, 3)
    ENC_NC = (64, 128, 256, 512, 512, 512)

    def __init__(self, fg: bool = False, cin: int = 3, compute_dtype=None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__(fg, cin, compute_dtype=compute_dtype)
        place(self, device, generator)


class CRNSmall(CRN):
    ENC_REPEATS = (2, 2, 2, 2, 2, 2)
    ENC_NC = (64, 128, 256, 256, 512, 512)
