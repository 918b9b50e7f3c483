"""The yardstick's arithmetic for the flow path: FlowNet2's model FLOPs
per training sample at a cell's shapes, and the least time of the
correlation kernels (B4, ``csrc/correlation.cu``).

FLOPs are the plain reference's (``benchmark/reference/flownet2.py``):
its convolutions and their gradients counted by ``counts.count_flops``
while it trains one sample on the ``meta`` device, plus the correlation's
multiply-adds (an elementwise product and a channel sum there, which the
counter does not see), 2 per multiply-add. B4's least time is the larger
of its operations at a peak and its bytes at the HBM's: each input read
once and each output written once.
"""

from __future__ import annotations

import functools

import torch

from benchmark import counts

MAX_DISPLACEMENT, STRIDE2, CORR_CHANNELS = 20, 2, 256


def corr_displacements(md: int = MAX_DISPLACEMENT,
                       s2: int = STRIDE2) -> int:
    """D, the cost volume's channels: (2 md / s2 + 1)²."""
    return (2 * (md // s2) + 1) ** 2


def b4_flops(shape, md: int = MAX_DISPLACEMENT, s2: int = STRIDE2,
             backward: bool = False) -> int:
    """The forward's multiply-adds, 2 each, at (B, C, H, W); the backward
    computes two gradients of as many."""
    B, C, H, W = shape
    return 2 * B * C * H * W * corr_displacements(md, s2) * (
        2 if backward else 1)


def b4_bytes(shape, md: int = MAX_DISPLACEMENT, s2: int = STRIDE2,
             itemsize: int = 2, backward: bool = False) -> int:
    """Forward: f1 and f2 read, the volume written. Backward: the volume's
    gradient, f1 and f2 read, both gradients written."""
    B, C, H, W = shape
    feat, vol = B * C * H * W, B * corr_displacements(md, s2) * H * W
    return itemsize * ((vol + 4 * feat) if backward else (2 * feat + vol))


def b4_bound_s(shape, md: int = MAX_DISPLACEMENT, s2: int = STRIDE2,
               itemsize: int = 2, backward: bool = False,
               peak_flops: float = counts.PEAK_BF16_FLOPS) -> float:
    """B4's least time: operations at ``peak_flops`` (the dense bf16 peak
    unless given) or bytes at the HBM's peak, whichever is longer."""
    return max(b4_flops(shape, md, s2, backward) / peak_flops,
               b4_bytes(shape, md, s2, itemsize, backward)
               / counts.PEAK_HBM_BYTES)


def corr_shape(crop) -> tuple:
    """FlowNetC's cost-volume input per sample at a (H, W) crop: conv3's
    256 channels at 1/8 of the size."""
    return (1, CORR_CHANNELS, crop[0] // 8, crop[1] // 8)


@functools.lru_cache(maxsize=None)
def _conv_flops(H: int, W: int) -> int:
    from benchmark.reference.flownet2 import FlowNet2, l1_and_epe

    m = torch.device("meta")
    net = FlowNet2().to(m)

    def train_one():
        fused = net(torch.empty(1, 3, 2, H, W, device=m))
        l1_and_epe(fused, torch.empty(1, 2, H, W, device=m))[0].backward()
    return counts.count_flops(train_one)


def flownet2_flops_per_sample(cfg: dict) -> int:
    """One training sample at the configuration's crop: the five nets'
    convolutions forward and backward, and the correlation's forward and
    backward."""
    H, W = cfg["crop_size"]
    shape = corr_shape((H, W))
    return (_conv_flops(H, W) + b4_flops(shape)
            + b4_flops(shape, backward=True))
