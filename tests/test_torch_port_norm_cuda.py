"""The ConvBlock norm's kernels (``jafpro_tpu_torch/csrc/norm.cu``) against
the plain form on the card, forward and backward, bfloat16 and float32, at
the served CRN's shapes; two runs give the same bits; every call on the
card takes the kernels or raises, and leaves one span.

Marked ``cuda``: each test skips where there is no CUDA device (decided
inside the test). Run on a GPU host with
``python -m pytest tests/test_torch_port_norm_cuda.py -q -m cuda
--noconftest``.

Tolerances:
- outputs: the rounded pre-activation (no LeakyReLU) at most one bfloat16
  ulp of the plain form's value in bfloat16 (values under 1/64 taken at
  1/64: the two forms' float32 statistics differ in the last bits, ~1e-6
  absolute after the affine), and the output the LeakyReLU of the
  kernels' own pre-activation bit for bit (one ulp of a negative
  pre-activation can be two of 0.01 times it, which may cross a binade
  where it does not); 1e-5 absolute and relative in float32.
- gradients, relative L2 against autograd of the plain form: dx 1e-2 in
  bfloat16 (the plain form rounds the LeakyReLU's gradient to bfloat16,
  2^-9 relative, and both round dx once), 1e-4 in float32; dgamma and
  dbeta 1e-3 in bfloat16, 1e-4 in float32. The incoming gradient is zero
  where the plain form's pre-activation lies within 1e-3 of 0: there the
  two forms' statistics may round it to opposite signs, and a slope of 1
  against 0.01 on one element is no error of the formula.
"""

import time

import pytest
import torch

from jafpro_tpu_torch.ops import norm as N
from jafpro_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

SLOPE = 0.01
CASES = {
    # the refine CRN's final block at 4 frames (a training step's frames)
    "final": ((4, 256, 256, 256), 1, False),
    # the encoder's first level, channels-last as a permuted image gives it
    "encoder_cl": ((4, 64, 256, 256), 1, True),
    # a deep level of the served 30 frames
    "deep": ((30, 512, 4, 4), 1, False),
    # a groups=24 part block of the zoo's part encoders
    "parts": ((2, 24 * 64, 25, 25), 24, False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make(case, dtype, dev, seed=0):
    shape, groups, cl = CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    C = shape[1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    if cl:
        x = x.contiguous(memory_format=torch.channels_last)
    gamma = torch.rand(C, generator=g, device=dev) + 0.1
    beta = torch.randn(C, generator=g, device=dev) * 0.3
    grad = torch.randn(shape, generator=g, device=dev).to(dtype)
    return x, gamma, beta, groups, grad


def bf16_ulp(v):
    m = v.float().abs().clamp_min(1.0 / 64)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def run_kernel(x, gamma, beta, groups, grad):
    xa, ga, ba = (t.detach().clone().requires_grad_() for t in
                  (x, gamma, beta))
    y = N.sample_norm(xa, ga, ba, groups, 1e-5, SLOPE)
    y.backward(grad)
    return y.detach(), xa.grad, ga.grad, ba.grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain(cuda, case, dtype):
    x, gamma, beta, groups, grad = make(case, dtype, cuda)
    pre = N.sample_norm_plain(x, gamma, beta, groups, 1e-5)
    grad = torch.where(pre.float().abs() < 1e-3, torch.zeros_like(grad),
                       grad)
    launches = (N.sample_norm.launches, N.sample_norm.backward_launches)
    y, dx, dg, db = run_kernel(x, gamma, beta, groups, grad)
    torch.cuda.synchronize()
    assert (N.sample_norm.launches, N.sample_norm.backward_launches) == (
        launches[0] + 2, launches[1] + 2)
    assert y.dtype == dtype and y.stride() == x.stride()
    xa, ga, ba = (t.detach().clone().requires_grad_() for t in
                  (x, gamma, beta))
    want = N.sample_norm_plain(xa, ga, ba, groups, 1e-5, SLOPE)
    want.backward(grad)
    if dtype == torch.bfloat16:
        with torch.no_grad():
            got_pre = N.sample_norm(x, gamma, beta, groups, 1e-5)
        diff = (got_pre.float() - pre.float()).abs()
        assert bool((diff <= bf16_ulp(pre)).all()), diff.max()
        assert torch.equal(y, torch.nn.functional.leaky_relu(got_pre, SLOPE))
    else:
        torch.testing.assert_close(y, want.detach(), rtol=1e-5, atol=1e-5)
    dx_tol, p_tol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    assert rel_l2(dx, xa.grad) < dx_tol
    assert rel_l2(dg, ga.grad) < p_tol
    assert rel_l2(db, ba.grad) < p_tol
    again = run_kernel(x, gamma, beta, groups, grad)
    for a, b in zip((y, dx, dg, db), again):
        assert torch.equal(a, b)


def test_card_takes_the_kernels_and_spans(cuda):
    """On the card a layout the kernels do not read is made contiguous and
    takes them; float64 raises; each kernel call is a ``nets.norm`` span
    counting its least bytes."""
    x, gamma, beta, _, _ = make("deep", torch.bfloat16, cuda)
    odd = x.transpose(2, 3)
    with pytest.raises(TypeError):
        N.sample_norm(x.double(), gamma, beta, 1, 1e-5, SLOPE)
    before = N.sample_norm.launches
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        yodd = N.sample_norm(odd, gamma, beta, 1, 1e-5, SLOPE)
        N.sample_norm(x, gamma, beta, 1, 1e-5, SLOPE)
        torch.cuda.synchronize()
        recs = profiling.spans(t0)
    assert N.sample_norm.launches == before + 4
    want = N.sample_norm_plain(odd, gamma, beta, 1, 1e-5, SLOPE)
    assert bool(((yodd.float() - want.float()).abs()
                 <= bf16_ulp(want)).all())
    recs = [r for r in recs if r["name"].startswith("nets.norm")]
    assert [r["name"] for r in recs] == ["nets.norm", "nets.norm"]
    assert recs[-1]["n"] == 2 * x.numel() * x.element_size()
