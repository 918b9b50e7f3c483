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
- ``launch_plan`` gives the kernels' blocks and dynamic shared memory for a
  shape, as ``jafpro_correlation_plan`` in the source computes them; the
  wrappers refuse a shape it refuses.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WINDOW = 41  # the kernel's largest n = 2·md/s2 + 1
MAX_STRIDE2 = 8  # s2 classes x 8 / s2 warps: at most 8 warps a block
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper
_COL_SLOTS, _PIX_SLOTS, _CHUNKS_MAX, _STAGES = 8, 4, 4, 4  # as the source


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


def launch_plan(shape, max_displacement: int, stride2: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """The kernels' launch for (B, C, H, W): ``{"forward": {...},
    "backward": {...}}``, each with ``grid`` (x-tiles, H, B or B · channel
    groups), ``threads`` and ``smem`` bytes (the backward's per gradient
    kernel), plus the tiling: ``n``, ``nc`` (band columns of a 16-pixel
    class tile, 8 per n-tile), ``wpc`` (warps per parity class), ``xt``
    (pixels per block); the forward's ``f1_resident`` says whether f1's
    row stays in shared memory for all dy (else its chunks are streamed
    with f2's, which takes any C). Mirrors ``make_plan`` in
    ``csrc/correlation.cu``; raises ValueError for a shape the kernels do
    not take."""
    md, s2 = max_displacement, stride2
    B, C, H, W = shape
    if dtype not in _DTYPES:
        raise ValueError(f"the correlation kernel takes float32 or bfloat16, "
                         f"not {dtype}")
    if md < 0 or s2 < 1 or md % s2 or min(shape) < 1:
        raise ValueError(f"no launch for shape {tuple(shape)}, md {md}, s2 "
                         f"{s2}")
    n = window(md, s2)
    if n > MAX_WINDOW or s2 > MAX_STRIDE2:
        raise ValueError(f"the kernel takes at most {MAX_WINDOW} "
                         f"displacements a side and stride2 <= "
                         f"{MAX_STRIDE2}, got n {n}, s2 {s2}")
    f32 = dtype == torch.float32
    nt = next(t for t in (3, 5, 7) if 8 * t >= 15 + n)
    nc = 8 * nt
    wpc = max(1, 8 // s2)
    xt = 16 * s2
    tiles_x = -(-W // xt)
    threads = 32 * s2 * wpc
    # forward: f1's row (resident, or a ring of its chunks where it does
    # not fit), a ring of f2's chunks of kc channel words (a word is 1
    # float32 or 2 bfloat16), the partial P tiles of every warp
    kc = 8 * wpc
    nq = -(-(C if f32 else -(-C // 2)) // kc)
    sa = xt + 8
    sb = s2 * nc + (0 if (s2 * nc) % 16 else 8)
    ncp = nc + (0 if nc % 16 else 8)
    rest = _STAGES * kc * sb + s2 * wpc * 16 * ncp
    resident = 4 * (nq * kc * sa + rest) <= SMEM_LIMIT
    fwd = 4 * ((nq if resident else _STAGES) * kc * sa + rest)
    # backward: rings of G and of the other map's chunks of cc channels, K
    # over the band columns (pairs for bfloat16)
    nck = nc if f32 else -(-nc // 16) * 16
    sg = (nck if f32 else nck // 2) + 4
    cc = 16 * wpc
    groups = -(-C // (_CHUNKS_MAX * cc))
    bwd = 4 * _STAGES * s2 * (16 + cc) * sg
    if s2 * nck > 32 * _COL_SLOTS or xt > 32 * _PIX_SLOTS:
        raise ValueError(f"no launch for n {n}, s2 {s2}: a staged row spans "
                         f"more than {32 * _COL_SLOTS} columns")
    if max(fwd, bwd) > SMEM_LIMIT:
        raise ValueError(f"the correlation kernels need {fwd} (forward) and "
                         f"{bwd} (backward) bytes of shared memory for "
                         f"{tuple(shape)}; a block has {SMEM_LIMIT}")
    return {"n": n, "nc": nc, "wpc": wpc, "xt": xt,
            "forward": {"grid": (tiles_x, H, B), "threads": threads,
                        "smem": fwd, "f1_resident": resident},
            "backward": {"grid": (tiles_x, H, B * groups),
                         "threads": threads, "smem": bwd}}


def _library() -> ctypes.CDLL:
    from jafpro_tpu_torch import cuda_build

    lib = cuda_build.load("correlation.cu")
    if lib.jafpro_correlation_forward.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.jafpro_correlation_forward.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
        lib.jafpro_correlation_backward.argtypes = [vp] * 5 + [ci] * 7 + [vp]
        lib.jafpro_correlation_plan.argtypes = [ci] * 7 + [ctypes.POINTER(ci)]
        for fn in (lib.jafpro_correlation_forward,
                   lib.jafpro_correlation_backward,
                   lib.jafpro_correlation_plan):
            fn.restype = ci
    return lib


def kernel_plan(shape, max_displacement: int, stride2: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """``launch_plan``'s grids, threads and shared memory as the built
    source computes them (``jafpro_correlation_plan``). Raises RuntimeError
    for a shape the source refuses."""
    out = (ctypes.c_int * 10)()
    rc = _library().jafpro_correlation_plan(*shape, max_displacement,
                                            stride2, _DTYPES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"the correlation source refuses {tuple(shape)}: "
                           f"CUDA error {rc}")
    v = list(out)
    return {"forward": {"grid": tuple(v[0:3]), "threads": v[3],
                        "smem": v[4]},
            "backward": {"grid": tuple(v[5:8]), "threads": v[8],
                         "smem": v[9]}}


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
    n = launch_plan(f1.shape, md, s2, f1.dtype)["n"]
    B, C, H, W = f1.shape
    out = torch.empty((B, n * n, H, W), dtype=f1.dtype, device=f1.device)
    fwd = _library().jafpro_correlation_forward
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
    if grad.shape != (B, launch_plan(f1.shape, md, s2, f1.dtype)["n"] ** 2,
                      H, W):
        raise ValueError(f"grad has shape {tuple(grad.shape)}")
    g1, g2 = torch.empty_like(f1), torch.empty_like(f2)
    bwd = _library().jafpro_correlation_backward
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
