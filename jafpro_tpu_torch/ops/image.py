"""Pooling and per-pixel image ops (port of ``jafpro_tpu/ops/image.py``),
on (B, C, H, W) tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """Avg pool k=3 s=2 p=1, count_include_pad=True (torch default).

    A tensor that needs a gradient is made contiguous first: on CUDA,
    ``avg_pool2d``'s backward of a channels-last input (what a conv gives
    a permuted channels-last image) is wrong, off by ~100% relative against
    the CPU and float64 (measured on an H100, torch 2.11). Its forward is
    right, so inference keeps the layout it is given."""
    if x.requires_grad:
        x = x.contiguous()
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """Max pool k=3 s=2 p=1."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def channel_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """Per-pixel L2 norm across the channel axis."""
    return torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=keepdim))
