"""The 24-part U-Net encoder/decoder stacks (port of
``jafpro_tpu/models/parts.py``), NCHW with the parts packed part-major into
the channel axis: (B, P*C, H, W), channel ``p*C + c``.

Every per-part conv is one grouped ``nn.Conv2d(P*cin, P*cout, k,
groups=P)``: numerically P independent convs, the JAX ``PartConv`` under
any of its lowerings. The flax kernel (P, k, k, cin, cout) maps to the
grouped weight (P*cout, cin, k, k), part-major (``bridge.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.models.common import Conv2d
from jafpro_tpu_torch.ops.sampling import resize_bilinear

ENC_NC = (12, 24, 24, 24, 24, 48, 48, 96, 96)


def pack_parts(x: torch.Tensor) -> torch.Tensor:
    """(B, P, h, w, C) -> packed (B, P*C, h, w) (part-major channels)."""
    B, P, h, w, C = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(B, P * C, h, w)


def unpack_parts(x: torch.Tensor, parts: int) -> torch.Tensor:
    """(B, P*C, h, w) -> (B, P, h, w, C)."""
    B, _, h, w = x.shape
    return x.reshape(B, parts, -1, h, w).permute(0, 1, 3, 4, 2)


def part_cat(a: torch.Tensor, b: torch.Tensor, parts: int) -> torch.Tensor:
    """Per-part channel concat of two packed tensors:
    (B, P*ca, H, W) + (B, P*cb, H, W) -> (B, P*(ca+cb), H, W)."""
    B, _, H, W = a.shape
    return torch.cat([a.reshape(B, parts, -1, H, W),
                      b.reshape(B, parts, -1, H, W)], dim=2).reshape(
                          B, -1, H, W)


class PartConv(Conv2d):
    """P independent per-part convs as one grouped conv (``groups=P``)."""

    def __init__(self, parts: int, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True, compute_dtype=None):
        super().__init__(parts * cin, parts * features, kernel, stride,
                         kernel // 2, bias=use_bias, groups=parts,
                         compute_dtype=compute_dtype)
        self.parts = parts


class GroupConvLReLU(nn.Module):
    """P independent conv + LeakyReLU(0.2) over one or more packed inputs:
    ``conv(per-part concat(a, b)) == conv_a(a) + conv_b(b)``, one
    ``PartConv_i`` per input, the bias on the first only."""

    def __init__(self, parts: int, cins: Sequence[int], features: int,
                 kernel: int = 3, stride: int = 1, act: bool = True,
                 negative_slope: float = 0.2, compute_dtype=None):
        super().__init__()
        self.act = act
        self.negative_slope = negative_slope
        self.n_inputs = len(cins)
        for i, cin in enumerate(cins):
            self.add_module(f"PartConv_{i}", PartConv(
                parts, cin, features, kernel=kernel, stride=stride,
                use_bias=(i == 0), compute_dtype=compute_dtype))

    def forward(self, *inputs):
        if len(inputs) != self.n_inputs:
            raise ValueError(f"expected {self.n_inputs} inputs")
        out = None
        for i, x in enumerate(inputs):
            y = getattr(self, f"PartConv_{i}")(x)
            out = y if out is None else out + y
        if self.act:
            out = F.leaky_relu(out, self.negative_slope)
        return out


class PartEncoder(nn.Module):
    """The 9-conv per-part encoder for all P parts at once. Input
    (B, P*cin, H, W); returns the skips (x1, x3, x5, x7, x9), packed."""

    def __init__(self, parts: int = 24, cin: int = 3,
                 enc_nc: Sequence[int] = ENC_NC, compute_dtype=None):
        super().__init__()
        strides = (1, 2, 1, 2, 1, 2, 1, 2, 1)
        c = cin
        for i, (f, s) in enumerate(zip(enc_nc, strides)):
            self.add_module(f"GroupConvLReLU_{i}", GroupConvLReLU(
                parts, [c], f, kernel=5 if i == 0 else 3, stride=s,
                compute_dtype=compute_dtype))
            c = f

    def forward(self, x):
        outs = []
        for i in range(9):
            x = getattr(self, f"GroupConvLReLU_{i}")(x)
            outs.append(x)
        return outs[0], outs[2], outs[4], outs[6], outs[8]


class PartDecoder(nn.Module):
    """Per level: bilinear resize (align_corners) to the skip's size,
    per-part concat with the skip, grouped conv + LeakyReLU; a 3x3 grouped
    head to P*3 channels. ``bottleneck_cins``: per-part channels of extra
    inputs that join x9 at the first level (the inpainter's global code)."""

    def __init__(self, parts: int = 24,
                 dec_nc: Sequence[int] = (48, 24, 12, 6),
                 enc_nc: Sequence[int] = ENC_NC,
                 bottleneck_cins: Sequence[int] = (), compute_dtype=None):
        super().__init__()
        skip_cs = (enc_nc[6], enc_nc[4], enc_nc[2], enc_nc[0])
        cins = [enc_nc[8], *bottleneck_cins]
        for i, (f, cs) in enumerate(zip(dec_nc, skip_cs)):
            self.add_module(f"GroupConvLReLU_{i}", GroupConvLReLU(
                parts, [*cins, cs], f, compute_dtype=compute_dtype))
            cins = [f]
        self.add_module("GroupConvLReLU_4", GroupConvLReLU(
            parts, [dec_nc[-1]], 3, act=False, compute_dtype=compute_dtype))

    def forward(self, skips, bottleneck=()):
        x1, x3, x5, x7, x9 = skips
        xs = [x9, *bottleneck]
        for i, skip in enumerate((x7, x5, x3, x1)):
            size = tuple(skip.shape[-2:])
            ups = [resize_bilinear(x, size, align_corners=True) for x in xs]
            xs = [getattr(self, f"GroupConvLReLU_{i}")(*ups, skip)]
        return self.GroupConvLReLU_4(xs[0])
