"""Shared building blocks (port of ``jafpro_tpu/models/common.py``), NCHW.

Children carry the names flax gives their counterparts (``Conv_0``,
``SampleLayerNorm_1``, ...), so a JAX param tree maps onto a
``state_dict`` by path (``bridge.py``). ``compute_dtype`` is flax's
``dtype``: a conv casts its input, kernel and bias to it; norms compute in
float32 and cast back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.ops.sampling import resize_bilinear


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with symmetric padding that computes in
    ``compute_dtype`` (None: the input's dtype), like flax ``nn.Conv``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, groups: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, 1, self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (None: the input's
    dtype), like flax ``nn.Dense``; the flax kernel (in, out) is the
    transposed weight (``bridge.py``)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class ConvLReLU(nn.Module):
    """Conv + LeakyReLU(0.2) (the reference's ``Downsampler``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, negative_slope: float = 0.2,
                 compute_dtype=None):
        super().__init__()
        self.negative_slope = negative_slope
        self.Conv_0 = Conv2d(cin, features, kernel, stride, kernel // 2,
                             compute_dtype=compute_dtype)

    def forward(self, x):
        return F.leaky_relu(self.Conv_0(x), self.negative_slope)


class UpsampleConvLReLU(nn.Module):
    """Bilinear resize (align_corners) to a fixed size, concat the skip,
    conv + LeakyReLU (the reference's ``Upsampler_SE``)."""

    def __init__(self, cin: int, cskip: int, features: int, output_size: int,
                 compute_dtype=None):
        super().__init__()
        self.output_size = output_size
        self.ConvLReLU_0 = ConvLReLU(cin + cskip, features,
                                     compute_dtype=compute_dtype)

    def forward(self, x, skip):
        x = resize_bilinear(x, (self.output_size, self.output_size), True)
        return self.ConvLReLU_0(torch.cat([x, skip], dim=1))


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` as flax ``nn.BatchNorm`` runs it: the input is
    promoted to the params' type (float32) and so is the output. In
    training the batch's biased variance normalises the input and also
    moves the running variance (torch would move it by the unbiased one,
    N/(N-1) larger): ``running = (1 - momentum) * running + momentum *
    batch``, flax's 0.99 decay at the default momentum 0.01. Names and
    buffers are ``nn.BatchNorm2d``'s, so the bridge's rule applies."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.01):
        super().__init__(features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        if x.numel() == x.shape[1]:
            # one value per channel, which F.batch_norm refuses in training
            # and flax normalises to its shift
            shape = (1, -1, 1, 1)
            d = x - x.mean(dim=(0, 2, 3), keepdim=True)
            v = d.square().mean(dim=(0, 2, 3), keepdim=True)
            return (d * torch.rsqrt(v + self.eps) * self.weight.view(shape)
                    + self.bias.view(shape))
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


class SampleLayerNorm(nn.Module):
    """The CRN's LayerNorm: per-sample statistics over all of (C, H, W)
    with Bessel-corrected std, (x - mean) / (std + eps), per-channel affine."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x32 = x.float()
        dims = tuple(range(1, x.ndim))
        n = math.prod(x.shape[1:])
        mean = x32.mean(dim=dims, keepdim=True)
        var = torch.square(x32 - mean).sum(dim=dims, keepdim=True) / (n - 1)
        y = (x32 - mean) / (torch.sqrt(var) + self.eps)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (y * self.gamma.view(shape) + self.beta.view(shape)).to(x.dtype)


class ConvBlock(nn.Module):
    """n_repeats x [conv3x3, SampleLayerNorm, LeakyReLU(0.01)]."""

    def __init__(self, n_repeats: int, cin: int, features: int,
                 compute_dtype=None):
        super().__init__()
        self.n_repeats = n_repeats
        for i in range(n_repeats):
            self.add_module(f"Conv_{i}", Conv2d(
                cin if i == 0 else features, features, 3, padding=1,
                compute_dtype=compute_dtype))
            self.add_module(f"SampleLayerNorm_{i}", SampleLayerNorm(features))

    def forward(self, x):
        for i in range(self.n_repeats):
            x = getattr(self, f"Conv_{i}")(x)
            x = getattr(self, f"SampleLayerNorm_{i}")(x)
            x = F.leaky_relu(x, 0.01)
        return x


class ReflectConv(nn.Module):
    """ReflectionPad + valid conv."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True, compute_dtype=None):
        super().__init__()
        self.pad = kernel // 2
        self.Conv_0 = Conv2d(cin, features, kernel, stride, 0, bias=use_bias,
                             compute_dtype=compute_dtype)

    def forward(self, x):
        p = self.pad
        return self.Conv_0(F.pad(x, (p, p, p, p), mode="reflect"))


def _truncated_normal_(t: torch.Tensor, std: float,
                       generator: torch.Generator) -> None:
    """Normal(0, std) truncated to +-2 std, by inverse CDF on the CPU."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float64).uniform_(
        lo, 1.0 - lo, generator=generator)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
    with torch.no_grad():
        t.copy_((z * std).to(t.dtype))


def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module``'s parameters with flax's default initialisers
    (lecun truncated-normal kernels of convs, transposed convs and dense
    layers, zero biases, uniform [0, 1) LayerNorm gamma), drawing from
    ``generator``
    (a CPU generator) in module order."""
    # stddev of a unit-variance normal truncated to +-2 (flax's constant)
    trunc = 0.87962566103423978
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # OIHW / (cin, cout, kh, kw): flax counts cin * kh * kw
                cin = m.weight.shape[
                    0 if isinstance(m, nn.ConvTranspose2d) else 1]
                fan_in = cin * m.weight.shape[2] * m.weight.shape[3]
                _truncated_normal_(m.weight, math.sqrt(1.0 / fan_in) / trunc,
                                   generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                _truncated_normal_(m.weight, math.sqrt(
                    1.0 / m.weight.shape[1]) / trunc, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, SampleLayerNorm):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=generator))
                m.beta.zero_()
    return module
