"""GAN discriminators (port of ``jafpro_tpu/models/discriminators.py``),
NCHW (reference ``src/networks.py:356-456``).

``ImageDiscriminator``: 6 stride-2 DCGAN convs (256 -> 4) + MLP + sigmoid,
conditioned by channel concat (image (+) source frame, 6 channels in).
``FaceDiscriminator``: 4 convs for 64x64 face crops (face (+) face IUV).
Norms use the current batch's statistics (``per_sample=False``): the
reference never evaluates the discriminators outside training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.models.common import Conv2d, Linear
from jafpro_tpu_torch.models.propagation import BatchStatsNorm


class _ConvBNLReLU(nn.Module):
    def __init__(self, cin: int, features: int, norm: bool = True,
                 compute_dtype=None):
        super().__init__()
        self.norm = norm
        self.Conv_0 = Conv2d(cin, features, 3, stride=2, padding=1,
                             bias=False, compute_dtype=compute_dtype)
        if norm:
            self.BatchStatsNorm_0 = BatchStatsNorm(features)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.norm:
            x = self.BatchStatsNorm_0(x, per_sample=False)
        return F.leaky_relu(x, 0.2)


class _MLPHead(nn.Module):
    """Flatten, Dense(100), LeakyReLU(0.2), Dense(1), sigmoid. flax flattens
    a channels-last map, so the rows of ``Dense_0`` are in (H, W, C) order:
    the NCHW map is flattened in that order too."""

    def __init__(self, cin: int, compute_dtype=None):
        super().__init__()
        self.Dense_0 = Linear(cin, 100, compute_dtype=compute_dtype)
        self.Dense_1 = Linear(100, 1, compute_dtype=compute_dtype)

    def forward(self, x):
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.leaky_relu(self.Dense_0(x), 0.2)
        return torch.sigmoid(self.Dense_1(x))


class _Discriminator(nn.Module):
    def __init__(self, cin: int, layers, image_size: int, compute_dtype=None):
        super().__init__()
        c = cin
        for i, (f, norm) in enumerate(layers):
            self.add_module(f"_ConvBNLReLU_{i}", _ConvBNLReLU(
                c, f, norm, compute_dtype=compute_dtype))
            c = f
        self.n_layers = len(layers)
        side = image_size
        for _ in layers:
            side = (side + 1) // 2   # 3x3, stride 2, pad 1
        self._MLPHead_0 = _MLPHead(c * side * side,
                                   compute_dtype=compute_dtype)

    def forward(self, x):
        """x (B, cin, S, S) -> (B, 1) probabilities."""
        for i in range(self.n_layers):
            x = getattr(self, f"_ConvBNLReLU_{i}")(x)
        return self._MLPHead_0(x)


class ImageDiscriminator(_Discriminator):
    def __init__(self, image_size: int = 256, ndf: int = 32, cin: int = 6,
                 compute_dtype=None):
        super().__init__(cin, [(ndf, False), (ndf * 2, True),
                               (ndf * 2, True), (ndf * 4, True),
                               (ndf * 4, True), (ndf * 8, True)],
                         image_size, compute_dtype)


class FaceDiscriminator(_Discriminator):
    def __init__(self, image_size: int = 64, ndf: int = 32, cin: int = 6,
                 compute_dtype=None):
        super().__init__(cin, [(ndf, False), (ndf * 2, True),
                               (ndf * 2, True), (ndf * 4, True)],
                         image_size, compute_dtype)
