"""Cost-volume correlation (port of ``jafpro_tpu/ops/correlation.py``), the
layer FlowNetC builds its cost volume with (the reference's
``correlation_cuda``).

For each pixel and each displacement in a (2·md/s2+1)² window, the channel
mean of ``f1`` times the shifted, zero-padded ``f2``. NCHW: ``f1``, ``f2``
(B, C, H, W) -> (B, D, H, W), D = (2·md/s2+1)², displacements dy-major as
the reference CUDA kernel lays them out (the JAX package's (B, H, W, D)
moved to channels).

- ``correlation_reference`` is the plain version: shifted slices of the
  padded ``f2``, as the JAX ``lax.scan`` computes them. In bfloat16 the
  products and the mean are taken in float32 and the result rounded to
  bfloat16 once, as XLA runs the scan's multiply-and-mean fusion (the
  product is not rounded: on the CPU this form equals the JAX package's
  bfloat16 output).
- ``correlation_backward_reference`` is the plain form of the backward
  kernel's gathers, differentiable by nothing: the CPU tests hold it to
  autograd of the plain version.
- ``correlation`` launches the CUDA kernels of ``csrc/correlation.cu`` on
  CUDA tensors (forward, and the backward through an autograd Function),
  raising if they fail to build or launch; CPU tensors go through the plain
  version. ``correlation.launches`` and ``correlation.backward_launches``
  count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WINDOW = 41  # the kernel's largest n = 2·md/s2 + 1


def window(max_displacement: int, stride2: int) -> int:
    """n, the displacements along each axis; D = n²."""
    return 2 * (max_displacement // stride2) + 1


def _check(f1: torch.Tensor, f2: torch.Tensor, md: int, s2: int) -> None:
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"f1 and f2 must be (B, C, H, W) of one shape, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if f1.dtype != f2.dtype or f1.device != f2.device:
        raise ValueError("f1 and f2 must share a dtype and a device")
    if md < 0 or s2 < 1 or md % s2:
        raise ValueError(f"max_displacement {md} must be a non-negative "
                         f"multiple of stride2 {s2}")


def _offsets(md: int, s2: int) -> list:
    return list(range(-md, md + 1, s2))


def correlation_reference(f1: torch.Tensor, f2: torch.Tensor,
                          max_displacement: int = 20,
                          stride2: int = 2) -> torch.Tensor:
    """The plain version: (B, C, H, W) x2 -> (B, D, H, W) in f1's dtype,
    computed in float32."""
    md, s2 = max_displacement, stride2
    _check(f1, f2, md, s2)
    _, C, H, W = f1.shape
    a = f1.float()
    f2p = F.pad(f2.float(), (md, md, md, md))
    maps = []
    for dy in _offsets(md, s2):
        for dx in _offsets(md, s2):
            win = f2p[:, :, md + dy:md + dy + H, md + dx:md + dx + W]
            maps.append((a * win).sum(1) / C)
    return torch.stack(maps, 1).to(f1.dtype)


def correlation_backward_reference(grad: torch.Tensor, f1: torch.Tensor,
                                   f2: torch.Tensor,
                                   max_displacement: int = 20,
                                   stride2: int = 2) -> tuple:
    """The backward kernel's gathers in plain PyTorch, float32 sums:
    grad_f1[p] = Σ_d g[p, d] f2[p + d] / C and grad_f2[q] = Σ_d
    g[q − d, d] f1[q − d] / C, zero-padded. Returns both in f1's dtype."""
    md, s2 = max_displacement, stride2
    _check(f1, f2, md, s2)
    _, C, H, W = f1.shape
    g, a, b = grad.float(), f1.float(), f2.float()
    pad = (md, md, md, md)
    f2p = F.pad(b, pad)
    g1 = torch.zeros_like(a)
    g2p = torch.zeros_like(f2p)
    offs = _offsets(md, s2)
    k = 0
    for dy in offs:
        for dx in offs:
            gk = g[:, k:k + 1]
            g1 += gk * f2p[:, :, md + dy:md + dy + H, md + dx:md + dx + W]
            g2p[:, :, md + dy:md + dy + H, md + dx:md + dx + W] += gk * a
            k += 1
    g2 = g2p[:, :, md:md + H, md:md + W]
    return (g1 / C).to(f1.dtype), (g2 / C).to(f1.dtype)


def _library():
    from jafpro_tpu_torch import cuda_build

    lib = cuda_build.load("correlation.cu")
    fwd, bwd = lib.jafpro_correlation_forward, lib.jafpro_correlation_backward
    if fwd.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
        fwd.restype = ci
        bwd.argtypes = [vp] * 5 + [ci] * 7 + [vp]
        bwd.restype = ci
    return fwd, bwd


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda" or t.dtype not in _DTYPES or (
                not t.is_contiguous()):
            raise ValueError("the correlation kernel takes contiguous "
                             "float32 or bfloat16 CUDA tensors")


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     max_displacement: int = 20,
                     stride2: int = 2) -> torch.Tensor:
    """Launch the forward kernel (CUDA tensors only): (B, D, H, W)."""
    md, s2 = max_displacement, stride2
    _check(f1, f2, md, s2)
    _check_cuda(f1, f2)
    n = window(md, s2)
    if n > MAX_WINDOW:
        raise ValueError(f"the kernel takes at most {MAX_WINDOW} "
                         f"displacements a side, got {n}")
    B, C, H, W = f1.shape
    out = torch.empty((B, n * n, H, W), dtype=f1.dtype, device=f1.device)
    fwd, _ = _library()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fwd(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W,
                 md, s2, _DTYPES[f1.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"correlation forward kernel launch failed: CUDA "
                           f"error {rc}")
    correlation.launches += 1
    return out


def correlation_backward_cuda(grad: torch.Tensor, f1: torch.Tensor,
                              f2: torch.Tensor, max_displacement: int = 20,
                              stride2: int = 2) -> tuple:
    """Launch the backward kernels (CUDA tensors only): (grad_f1,
    grad_f2)."""
    md, s2 = max_displacement, stride2
    _check(f1, f2, md, s2)
    grad = grad.to(f1.dtype).contiguous()
    _check_cuda(grad, f1, f2)
    B, C, H, W = f1.shape
    if grad.shape != (B, window(md, s2) ** 2, H, W):
        raise ValueError(f"grad has shape {tuple(grad.shape)}")
    g1, g2 = torch.empty_like(f1), torch.empty_like(f2)
    _, bwd = _library()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = bwd(grad.data_ptr(), f1.data_ptr(), f2.data_ptr(),
                 g1.data_ptr(), g2.data_ptr(), B, C, H, W, md, s2,
                 _DTYPES[f1.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"correlation backward kernel launch failed: CUDA "
                           f"error {rc}")
    correlation.backward_launches += 1
    return g1, g2


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, md, s2):
        f1, f2 = f1.contiguous(), f2.contiguous()
        ctx.save_for_backward(f1, f2)
        ctx.md, ctx.s2 = md, s2
        return correlation_cuda(f1, f2, md, s2)

    @staticmethod
    def backward(ctx, grad):
        f1, f2 = ctx.saved_tensors
        g1, g2 = correlation_backward_cuda(grad, f1, f2, ctx.md, ctx.s2)
        return g1, g2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 20,
                stride2: int = 2) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, D, H, W): the CUDA kernels for CUDA tensors
    (differentiable through the backward kernels), the plain version for
    CPU tensors."""
    _check(f1, f2, max_displacement, stride2)
    if f1.device.type == "cpu":
        return correlation_reference(f1, f2, max_displacement, stride2)
    if f1.device.type != "cuda":
        raise ValueError(f"unsupported device {f1.device}")
    return _Correlation.apply(f1, f2, max_displacement, stride2)


correlation.launches = 0
correlation.backward_launches = 0
