"""The precision the reference computes in.

``"float32"`` is the reference: every operation in float32, with TF32 off
(``strict_float32``). ``"float8"`` is the correctness control, the nearest
precision below the configuration's bfloat16: the operands of every
convolution and dense layer are cast to float8 e4m3 with one scale per
tensor (its largest magnitude onto e4m3's largest finite value, 448) and
back, and the product is taken in float32. The gradient passes the cast
unchanged (a straight-through estimator), so the control also trains.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = ["float32"]
E4M3_MAX = 448.0


def strict_float32() -> None:
    """float32 means float32 on the card: no TF32 in matmuls or convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def use(mode: str):
    if mode not in ("float32", "float8"):
        raise ValueError(f"unknown precision {mode!r}")
    prev = _MODE[0]
    _MODE[0] = mode
    try:
        yield
    finally:
        _MODE[0] = prev


def fake_float8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to scaled float8 e4m3, in float32."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def operand(x: torch.Tensor) -> torch.Tensor:
    """One operand of a convolution or dense layer, in the reference's
    precision."""
    if _MODE[0] == "float8":
        return fake_float8(x)
    return x.float()
