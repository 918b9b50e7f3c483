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

from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.ops.norm import sample_norm
from jafpro_tpu_torch.ops.sampling import resize_bilinear


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with symmetric padding that computes in
    ``compute_dtype`` (None: the input's dtype), like flax ``nn.Conv``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, groups: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 dilation: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups, dilation=dilation)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight``: use it in place of ``self.weight`` (a spectrally
        normalised copy, say)."""
        dt = self.compute_dtype or x.dtype
        w = self.weight if weight is None else weight
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), w.to(dt), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype`` (None: the
    input's dtype), like flax ``nn.ConvTranspose``. torch's ``padding=p``
    crops p from every side of the VALID output, which is the reference's
    ``ConvTranspose2d(k, s, p)``; flax's ``"SAME"`` at k 3, s 2 is
    ``padding=0`` then ``crop_end=1`` (the last row and column dropped)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, groups: int = 1,
                 crop_end: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups)
        self.crop_end = crop_end
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), b, self.stride,
                               self.padding, 0, self.groups)
        c = self.crop_end
        return y[..., :y.shape[-2] - c, :y.shape[-1] - c] if c else y


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
    """Bilinear resize (align_corners) to a fixed size (None: the skip's),
    concat the skip, conv + LeakyReLU (the reference's ``Upsampler_SE``)."""

    def __init__(self, cin: int, cskip: int, features: int,
                 output_size: Optional[int], compute_dtype=None):
        super().__init__()
        self.output_size = output_size
        self.ConvLReLU_0 = ConvLReLU(cin + cskip, features,
                                     compute_dtype=compute_dtype)

    def forward(self, x, skip):
        size = ((self.output_size, self.output_size) if self.output_size
                else tuple(skip.shape[-2:]))
        x = resize_bilinear(x, size, True)
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
    with Bessel-corrected std, (x - mean) / (std + eps), per-channel affine.
    ``groups`` P > 1: P parts packed part-major in the channels, each with
    statistics of its own (P independent norms, as a vmap over parts).
    ``negative_slope``: a LeakyReLU of the result, in the same call
    (``ops/norm.py``: the kernels on the card, the plain form elsewhere)."""

    def __init__(self, features: int, eps: float = 1e-5, groups: int = 1):
        super().__init__()
        self.eps = eps
        self.groups = groups
        self.gamma = nn.Parameter(torch.empty(groups * features))
        self.beta = nn.Parameter(torch.zeros(groups * features))

    def forward(self, x, negative_slope: Optional[float] = None):
        return sample_norm(x, self.gamma, self.beta, self.groups, self.eps,
                           negative_slope)


class ConvBlock(nn.Module):
    """n_repeats x [conv3x3, SampleLayerNorm, LeakyReLU(0.01)]; ``groups``
    P > 1 runs P independent blocks over part-major packed channels
    (``cin`` and ``features`` per part)."""

    def __init__(self, n_repeats: int, cin: int, features: int,
                 compute_dtype=None, groups: int = 1):
        super().__init__()
        self.n_repeats = n_repeats
        P = groups
        for i in range(n_repeats):
            self.add_module(f"Conv_{i}", Conv2d(
                P * (cin if i == 0 else features), P * features, 3,
                padding=1, groups=P, compute_dtype=compute_dtype))
            self.add_module(f"SampleLayerNorm_{i}", SampleLayerNorm(
                features, groups=P))

    def forward(self, x):
        for i in range(self.n_repeats):
            x = getattr(self, f"Conv_{i}")(x)
            x = getattr(self, f"SampleLayerNorm_{i}")(x, 0.01)
        return x


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class SpectralNorm(nn.Module):
    """flax ``nn.SpectralNorm``'s state and arithmetic for one conv's
    kernel: ``u`` (1, cout) and ``sigma`` () as buffers. Each call runs one
    power-iteration step from ``u`` on the kernel as flax lays it out,
    (k*k*cin, cout), in float32 with eps 1e-12 (``u`` and ``v`` carry no
    gradient), and returns the weight divided by sigma = v W u^T; with
    ``update`` it also stores the new ``u`` and ``sigma``. flax keeps them
    in ``batch_stats`` under ``"<layer>/kernel/u"`` and
    ``"<layer>/kernel/sigma"``; ``layer_name`` is that ``<layer>``."""

    def __init__(self, features: int, layer_name: str = "Conv_0",
                 eps: float = 1e-12):
        super().__init__()
        self.layer_name = layer_name
        self.eps = eps
        self.register_buffer("u", torch.zeros(1, features))
        self.register_buffer("sigma", torch.ones(()))

    def init_state_(self, generator: torch.Generator) -> None:
        """flax's initial state: u ~ N(0, 1), sigma = 1."""
        with torch.no_grad():
            self.u.copy_(torch.randn(self.u.shape, generator=generator))
            self.sigma.fill_(1.0)

    def forward(self, weight: torch.Tensor,
                update: bool = False) -> torch.Tensor:
        """weight (cout, cin, k, k) -> the spectrally normalised weight."""
        w = weight.float().permute(2, 3, 1, 0).reshape(-1, weight.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t(), self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = ((v @ w) @ u.t())[0, 0]
        if update:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return weight.float() / torch.where(sigma != 0, sigma,
                                            torch.ones_like(sigma))


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection padding of the two spatial axes of (B, C, H, W)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


class ReflectConv(nn.Module):
    """ReflectionPad + valid conv."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True, compute_dtype=None):
        super().__init__()
        self.pad = kernel // 2
        self.Conv_0 = Conv2d(cin, features, kernel, stride, 0, bias=use_bias,
                             compute_dtype=compute_dtype)

    def forward(self, x):
        return self.Conv_0(reflect_pad(x, self.pad))


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
                cin = (m.weight.shape[0] // m.groups
                       if isinstance(m, nn.ConvTranspose2d)
                       else m.weight.shape[1])
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
            if hasattr(m, "init_state_"):
                m.init_state_(generator)
    return module


def place(module: nn.Module, device,
          generator: Optional[torch.Generator]) -> None:
    """The last step of an entry point's constructor: onto ``device`` (the
    card unless the caller asks for the CPU; raises when it names CUDA and
    there is none), with flax's initialisers drawn from ``generator``
    (seed 0 when None). ``device=None`` marks a child, which its parent
    initialises and places."""
    if device is None:
        return
    dev = resolve_device(device)
    init_params_(module, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    module.to(dev)


def mark_vmapped(module: nn.Module, parts: int,
                 part_axis: bool = False) -> nn.Module:
    """Mark ``module``'s subtree as the port of a flax ``nn.vmap`` over
    ``parts`` with per-part parameters: each flax leaf there is the stack,
    on a new leading axis, of one part's leaf, and the port holds the
    ``parts`` converted leaves concatenated on axis 0 (grouped convs,
    grouped norms; ``bridge.py``). ``part_axis``: each part's kernel is
    that of a ``PartConv(parts=1)`` and keeps its axis of 1."""
    for m in module.modules():
        m.flax_vmap = parts
        m.flax_part_axis = part_axis
    return module
