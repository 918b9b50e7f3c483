"""The CRN's ConvBlock norm: ``SampleLayerNorm`` followed by a LeakyReLU,
one kernel pair forward and one backward (``csrc/norm.cu``).

Per sample and group, the mean and the Bessel-corrected standard deviation
over the group's contiguous (C/G, H, W) elements; y = (x - mean) / (std +
eps) · gamma_c + beta_c in float32, rounded once to the input's type; then
the activation of that rounded value (``negative_slope`` None: none).

- ``sample_norm_plain`` is the plain form: the arithmetic
  ``models/common.py::SampleLayerNorm`` has always run, and then
  ``F.leaky_relu``. Tensors on the CPU run it.
- ``sample_norm`` launches the kernels for every tensor on the card
  (differentiable through the backward kernels): bfloat16 or float32,
  with float32 gamma and beta. They read contiguous NCHW (any ``groups``)
  and channels-last (``groups`` 1); another layout is made contiguous
  first. Another dtype, or a shape outside ``launch_plan``, raises. Each
  call on the card is a ``nets.norm`` span of ``utils/profiling.py``, with
  ``n`` its least bytes (the input read once and the output written once).
  ``sample_norm.launches`` and ``sample_norm.backward_launches`` count the
  kernels launched (two a call each way).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from jafpro_tpu_torch.utils.profiling import span

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256              # as the source
MAX_PARTS = 256            # statistics partials per segment: one a thread
BLOCKS_PER_SM = 8          # resident blocks of 256 threads an SM
MIN_CHUNK = 8192           # least elements of a statistics or apply block
MIN_ROW_CHUNK = 2048       # elements a backward warp takes at least
MAX_SEGMENT = 1 << 30      # int offsets within a segment in the source
MAX_GRID_Y = 65535


def sample_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, groups: int = 1, eps: float = 1e-5,
                      negative_slope: Optional[float] = None) -> torch.Tensor:
    """The plain form: float32 statistics per sample (and group), the
    affine, the cast back to ``x.dtype``, then LeakyReLU(negative_slope)."""
    x32 = x.float()
    dims = tuple(range(1, x.ndim))
    if groups > 1:
        x32 = x32.reshape(x.shape[0], groups, -1)
        dims = (2,)
    n = math.prod(x32.shape[d] for d in dims)
    mean = x32.mean(dim=dims, keepdim=True)
    var = torch.square(x32 - mean).sum(dim=dims, keepdim=True) / (n - 1)
    y = ((x32 - mean) / (torch.sqrt(var) + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (y * gamma.view(shape) + beta.view(shape)).to(x.dtype)
    return y if negative_slope is None else F.leaky_relu(y, negative_slope)


def layout(x: torch.Tensor, groups: int) -> Optional[int]:
    """The kernels' "inner" for ``x``: H·W for contiguous NCHW, 1 for
    channels-last with one group; None for a layout they do not take."""
    if x.is_contiguous():
        return math.prod(x.shape[2:])
    if groups == 1 and x.ndim == 4 and x.is_contiguous(
            memory_format=torch.channels_last):
        return 1
    return None


@functools.lru_cache(maxsize=1024)
def launch_plan(shape: tuple, groups: int, itemsize: int, aligned: bool,
                sms: int) -> Optional[dict]:
    """The kernels' launch for ``shape`` (N, C, ...) on a card of ``sms``
    SMs: segments ``S`` of ``L`` elements, ``K`` statistics blocks and
    ``tiles`` apply blocks per segment, ``vec`` (16-byte accesses:
    ``aligned`` pointers and L a multiple of 16 / itemsize); the backward's
    ``J`` warps per channel row, its ``tiles`` and ``bwd_vec`` (H·W a
    multiple of the vector). None for a shape the kernels do not take."""
    if len(shape) < 2:
        return None
    N, C = shape[0], shape[1]
    HW = math.prod(shape[2:])
    if groups < 1 or C % groups or N < 1:
        return None
    S, L = N * groups, C // groups * HW
    if L < 2 or L >= MAX_SEGMENT or S > MAX_GRID_Y:
        return None
    V = 16 // itemsize
    fill = sms * BLOCKS_PER_SM
    per = -(-fill // S)
    return {
        "S": S, "L": L, "HW": HW,
        "vec": int(aligned and L % V == 0),
        "K": max(1, min(MAX_PARTS, per, -(-L // MIN_CHUNK))),
        "tiles": max(1, min(per, -(-L // MIN_CHUNK))),
        "J": max(1, min(-(-fill * THREADS // 32 // (N * C)),
                        HW // MIN_ROW_CHUNK)),
        "bwd_vec": int(aligned and HW % V == 0),
    }


def _library() -> ctypes.CDLL:
    from jafpro_tpu_torch import cuda_build

    lib = cuda_build.load("norm.cu")
    if lib.sample_norm_forward.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sample_norm_forward.argtypes = (
            [vp] * 6 + [ci] * 9 + [cf, cf, vp])
        lib.sample_norm_backward.argtypes = (
            [vp] * 9 + [ci] * 8 + [cf, cf, vp])
        lib.sample_norm_forward.restype = ci
        lib.sample_norm_backward.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          groups: int, sms: int) -> dict:
    """The launch for ``x`` in a layout the kernels read; raises for what
    they do not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"sample_norm on the card takes bfloat16 or float32, "
                        f"not {x.dtype}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError(f"sample_norm on the card takes float32 gamma and "
                        f"beta, not {gamma.dtype} and {beta.dtype}")
    if (x.ndim < 2 or gamma.numel() != x.shape[1]
            or beta.numel() != x.shape[1]
            or gamma.device != x.device or beta.device != x.device):
        raise ValueError(f"sample_norm: gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} on {gamma.device} do not fit "
                         f"x {tuple(x.shape)} on {x.device}")
    inner = layout(x, groups)
    if inner is None:
        raise ValueError("sample_norm: the kernels read contiguous NCHW or "
                         "channels-last with one group")
    p = launch_plan(tuple(x.shape), groups, x.element_size(),
                    x.data_ptr() % 16 == 0, sms)
    if p is None:
        raise ValueError(f"sample_norm: shape {tuple(x.shape)} with groups "
                         f"{groups} is outside the kernels' range (segments "
                         f"of 2 to 2**30 elements, at most {MAX_GRID_Y})")
    return dict(p, inner=inner)


def _slope(negative_slope: Optional[float]) -> float:
    return 1.0 if negative_slope is None else float(negative_slope)


def sample_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, groups: int, eps: float,
                     negative_slope: Optional[float], plan: dict) -> tuple:
    """Launch the forward kernels: (output, per-segment (mean, std))."""
    S, K = plan["S"], plan["K"]
    y = torch.empty_like(x)
    scratch = torch.empty(S * (3 * K + 2), dtype=torch.float32,
                          device=x.device)
    stats = scratch[3 * S * K:]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().sample_norm_forward(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), stats.data_ptr(), S, plan["L"], K,
            plan["tiles"], plan["inner"], x.shape[1] // groups, groups,
            _DTYPES[x.dtype], plan["vec"], eps, _slope(negative_slope),
            stream)
    if rc != 0:
        raise RuntimeError(f"sample_norm forward kernel launch failed: CUDA "
                           f"error {rc}")
    sample_norm.launches += 2
    return y, stats


def sample_norm_backward_cuda(grad: torch.Tensor, x: torch.Tensor,
                              gamma: torch.Tensor, beta: torch.Tensor,
                              stats: torch.Tensor, groups: int, eps: float,
                              negative_slope: Optional[float]) -> tuple:
    """Launch the backward kernels on NCHW copies where ``x`` is
    channels-last: (dx, dgamma, dbeta)."""
    x = x.contiguous()
    grad = grad.to(x.dtype).contiguous()
    N, C = x.shape[:2]
    plan = launch_plan(tuple(x.shape), groups, x.element_size(),
                       x.data_ptr() % 16 == 0 and grad.data_ptr() % 16 == 0,
                       sm_count(x.device.index))
    J = plan["J"]
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    rowpart = torch.empty(2 * N * C * J, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().sample_norm_backward(
            x.data_ptr(), grad.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            stats.data_ptr(), rowpart.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), N, C, groups, plan["HW"], J,
            plan["tiles"], _DTYPES[x.dtype], plan["bwd_vec"], eps,
            _slope(negative_slope), stream)
    if rc != 0:
        raise RuntimeError(f"sample_norm backward kernel launch failed: CUDA "
                           f"error {rc}")
    sample_norm.backward_launches += 2
    return dx, dgamma, dbeta


class _SampleNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, negative_slope, plan):
        y, stats = sample_norm_cuda(x, gamma, beta, groups, eps,
                                    negative_slope, plan)
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.args = (groups, eps, negative_slope)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, gamma, beta, stats = ctx.saved_tensors
        dx, dgamma, dbeta = sample_norm_backward_cuda(
            grad, x, gamma, beta, stats, *ctx.args)
        return dx, dgamma, dbeta, None, None, None, None


def sample_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                groups: int = 1, eps: float = 1e-5,
                negative_slope: Optional[float] = None) -> torch.Tensor:
    """SampleLayerNorm (+ LeakyReLU): the kernels on the card, the plain
    form on the CPU (module docstring)."""
    if x.device.type != "cuda":
        return sample_norm_plain(x, gamma, beta, groups, eps, negative_slope)
    if layout(x, groups) is None:
        x = x.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    plan = _plan(x, gamma, beta, groups, sm_count(x.device.index))
    with span("nets.norm", n=2 * x.numel() * x.element_size()):
        if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                        or beta.requires_grad):
            return _SampleNorm.apply(x, gamma, beta, groups, eps,
                                     negative_slope, plan)
        return sample_norm_cuda(x, gamma, beta, groups, eps, negative_slope,
                                plan)[0]


sample_norm.launches = 0
sample_norm.backward_launches = 0
