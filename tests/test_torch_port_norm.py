"""The ConvBlock norm (``jafpro_tpu_torch/ops/norm.py``) on the CPU: its
plain form is the arithmetic ``SampleLayerNorm`` + ``F.leaky_relu`` have
always run, bit for bit; the backward kernels' formula, written out in
plain PyTorch, is autograd of that arithmetic; the CPU takes the plain
form; what the card's dispatch refuses; the launch plan. The kernels
themselves are held to the plain form on the card
(``tests/test_torch_port_norm_cuda.py``)."""

import math

import pytest
import torch
import torch.nn.functional as F

from jafpro_tpu_torch.models.common import ConvBlock, SampleLayerNorm
from jafpro_tpu_torch.ops import norm as N


def norm_before(x, gamma, beta, groups, eps=1e-5):
    """``SampleLayerNorm.forward`` as it was written before the kernels."""
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
    return (y * gamma.view(shape) + beta.view(shape)).to(x.dtype)


def norm64(x, gamma, beta, groups, eps, slope):
    """The same arithmetic carried out in float64 throughout."""
    N_, C = x.shape[:2]
    xs = x.reshape(N_, groups, -1)
    L = xs.shape[2]
    mean = xs.mean(dim=2, keepdim=True)
    var = torch.square(xs - mean).sum(dim=2, keepdim=True) / (L - 1)
    y = ((xs - mean) / (torch.sqrt(var) + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = y * gamma.view(shape) + beta.view(shape)
    return y if slope is None else F.leaky_relu(y, slope)


def backward_formula(grad, x, gamma, beta, groups=1, eps=1e-5,
                     negative_slope=None):
    """The backward kernels' formula (``csrc/norm.cu``), in ``x``'s
    precision (float32 for bfloat16): per segment mean and std as the
    forward takes them, s = std + eps, d = x - mean, the slope from the
    sign of the rounded pre-activation, g' = gamma_c · grad · slope, and
    dx = (g' - mean(g')) / s - d · sum(g' d) / ((L - 1) · std · s²),
    dgamma_c = sum g · d / s, dbeta_c = sum g. Returns (dx in x's dtype,
    dgamma, dbeta in gamma's)."""
    N_, C = x.shape[:2]
    ct = torch.promote_types(x.dtype, torch.float32)
    xs = x.to(ct).reshape(N_, groups, C // groups, -1)
    L = xs[0, 0].numel()
    seg = (2, 3)
    mean = xs.mean(dim=seg, keepdim=True)
    std = torch.sqrt(torch.square(xs - mean).sum(dim=seg, keepdim=True)
                     / (L - 1))
    s = std + eps
    d = xs - mean
    gam = gamma.to(ct).reshape(1, groups, -1, 1)
    r = (d / s * gam + beta.to(ct).reshape(1, groups, -1, 1)).to(x.dtype)
    slope = 1.0 if negative_slope is None else negative_slope
    g = grad.to(ct).reshape(xs.shape)
    g = torch.where(r > 0, g, g * slope)
    gp = g * gam
    mg = gp.sum(dim=seg, keepdim=True) / L
    kd = (gp * d).sum(dim=seg, keepdim=True) / ((L - 1) * std * s * s)
    dx = ((gp - mg) / s - d * kd).reshape(x.shape).to(x.dtype)
    dgamma = (g * d / s).sum(dim=(0, 3)).reshape(C).to(gamma.dtype)
    dbeta = g.sum(dim=(0, 3)).reshape(C).to(beta.dtype)
    return dx, dgamma, dbeta


def inputs(shape, groups, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    C = shape[1]
    x = (torch.randn(shape, generator=g) * 3 + 0.7).to(dtype)
    gamma = torch.rand(C, generator=g)
    beta = torch.randn(C, generator=g) * 0.3
    return x, gamma, beta


SHAPES = [((3, 24, 7, 5), 1), ((2, 48, 5, 9), 24), ((2, 72, 3, 3), 24),
          ((1, 5, 11, 13), 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_plain_form_is_the_arithmetic_before(dtype, shape, groups):
    """The plain form, the module and ``ConvBlock``'s norm step equal the
    code before the kernels bit for bit, NCHW and channels-last."""
    x, gamma, beta = inputs(shape, groups, dtype)
    want = norm_before(x, gamma, beta, groups)
    want_act = F.leaky_relu(want, 0.01)
    assert torch.equal(N.sample_norm_plain(x, gamma, beta, groups), want)
    assert torch.equal(
        N.sample_norm_plain(x, gamma, beta, groups, 1e-5, 0.01), want_act)
    m = SampleLayerNorm(shape[1] // groups, groups=groups)
    with torch.no_grad():
        m.gamma.copy_(gamma)
        m.beta.copy_(beta)
    assert torch.equal(m(x), want)
    assert torch.equal(m(x, 0.01), want_act)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert torch.equal(m(cl, 0.01), F.leaky_relu(
        norm_before(cl, gamma, beta, groups), 0.01))


def test_conv_block_is_the_arithmetic_before():
    torch.manual_seed(0)
    blk = ConvBlock(2, 3, 8, compute_dtype=torch.bfloat16)
    for i in range(2):
        getattr(blk, f"SampleLayerNorm_{i}").gamma.data.uniform_()
    x = torch.randn(2, 3, 9, 7)
    h = x
    for i in range(2):
        h = getattr(blk, f"Conv_{i}")(h)
        nm = getattr(blk, f"SampleLayerNorm_{i}")
        h = F.leaky_relu(norm_before(h, nm.gamma, nm.beta, 1), 0.01)
    assert torch.equal(blk(x), h)
    assert set(blk.state_dict()) == {
        "Conv_0.weight", "Conv_0.bias", "Conv_1.weight", "Conv_1.bias",
        "SampleLayerNorm_0.gamma", "SampleLayerNorm_0.beta",
        "SampleLayerNorm_1.gamma", "SampleLayerNorm_1.beta"}


def crossing_inputs(shape, groups, dtype):
    """Inputs whose pre-activation takes both signs in every segment."""
    x, gamma, beta = inputs(shape, groups, dtype, seed=3)
    return x, gamma + 0.1, beta


@pytest.mark.parametrize("slope", [0.01, None])
@pytest.mark.parametrize("shape,groups", SHAPES[:3])
def test_backward_formula_is_autograd_float64(shape, groups, slope):
    """In float64 the kernels' backward formula is autograd of the norm's
    arithmetic, with both of the LeakyReLU's slopes taken."""
    x, gamma, beta = (t.double() for t in crossing_inputs(
        shape, groups, torch.float64))
    grad = torch.randn(shape, generator=torch.Generator().manual_seed(5),
                       dtype=torch.float64)
    xa, ga, ba = (t.clone().requires_grad_() for t in (x, gamma, beta))
    y = norm64(xa, ga, ba, groups, 1e-5, slope)
    if slope is not None:
        assert (y > 0).any() and (y < 0).any()
    want = torch.autograd.grad(y, (xa, ga, ba), grad)
    got = backward_formula(grad, x, gamma, beta, groups, 1e-5,
                                       slope)
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape,groups", SHAPES[:3])
def test_backward_formula_is_autograd_of_the_plain_form(shape, groups):
    """In float32 the formula is autograd of the plain form itself, within
    float32 rounding (relative L2 1e-5)."""
    x, gamma, beta = crossing_inputs(shape, groups, torch.float32)
    grad = torch.randn(shape, generator=torch.Generator().manual_seed(6))
    xa, ga, ba = (t.clone().requires_grad_() for t in (x, gamma, beta))
    want = torch.autograd.grad(
        N.sample_norm_plain(xa, ga, ba, groups, 1e-5, 0.01), (xa, ga, ba),
        grad)
    got = backward_formula(grad, x, gamma, beta, groups, 1e-5,
                                       0.01)
    for w, g in zip(want, got):
        assert ((g - w).norm() / w.norm()).item() < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_cpu_takes_the_plain_form(dtype):
    x, gamma, beta = inputs((2, 8, 4, 4), 1, dtype)
    before = (N.sample_norm.launches, N.sample_norm.backward_launches)
    xa = x.clone().requires_grad_()
    y = N.sample_norm(xa, gamma, beta, 1, 1e-5, 0.01)
    y.sum().backward()
    assert torch.equal(y.detach(),
                       N.sample_norm_plain(x, gamma, beta, 1, 1e-5, 0.01))
    assert (N.sample_norm.launches, N.sample_norm.backward_launches) == before


def test_card_dispatch_rules():
    """What the card's dispatch refuses, read on the CPU: float64 and
    float16 inputs, parameters other than float32, a shape outside the
    launch plan; the two layouts the kernels read (another is made
    contiguous before ``_plan``)."""
    x, gamma, beta = inputs((2, 8, 4, 4), 1, torch.float32)
    assert N._DTYPES.keys() == {torch.float32, torch.bfloat16}
    assert N._plan(x, gamma, beta, 1, 132)["inner"] == 16
    for dt in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            N._plan(x.to(dt), gamma, beta, 1, 132)
    with pytest.raises(TypeError):
        N._plan(x, gamma.double(), beta, 1, 132)
    with pytest.raises(ValueError):
        N._plan(x[:, :, :1, :1].contiguous()[:, :1], gamma[:1], beta[:1],
                1, 132)   # a segment of one element
    with pytest.raises(ValueError):
        N._plan(x.transpose(2, 3), gamma, beta, 1, 132)
    assert N.layout(x, 1) == 16 and N.layout(x, 2) == 16
    cl = x.contiguous(memory_format=torch.channels_last)
    assert N.layout(cl, 1) == 1 and N.layout(cl, 2) is None
    assert N._plan(cl, gamma, beta, 1, 132)["inner"] == 1
    assert N.layout(x.transpose(2, 3), 1) is None
    assert N.layout(x[:, ::2], 1) is None


def test_launch_plan():
    """Grids at the served CRN's shapes (30 frames at 256²): every
    segment's partials fit one block (K <= 256), a small segment takes one
    statistics block, the vector path where L divides by the vector."""
    big = N.launch_plan((30, 256, 256, 256), 1, 2, True, 132)
    assert big["S"] == 30 and big["L"] == 256 * 65536
    assert 1 < big["K"] <= N.MAX_PARTS
    assert big["K"] * 30 >= 132 * N.BLOCKS_PER_SM
    assert big["vec"] == 1 and big["bwd_vec"] == 1
    deep = N.launch_plan((30, 512, 4, 4), 1, 2, True, 132)
    assert deep["K"] == 1 and deep["tiles"] == 1 and deep["J"] == 1
    train = N.launch_plan((4, 256, 256, 256), 1, 2, True, 132)
    assert train["K"] == N.MAX_PARTS and train["J"] > 1
    parts = N.launch_plan((2, 24 * 64, 25, 25), 24, 4, True, 132)
    assert parts["S"] == 48 and parts["vec"] == 1 and parts["bwd_vec"] == 0
    assert N.launch_plan((2, 24 * 64, 25, 25), 24, 2, True, 132)["vec"] == 1
    assert N.launch_plan((2, 3, 5, 5), 1, 2, True, 132)["vec"] == 0
    assert N.launch_plan((2, 8, 4, 4), 1, 2, False, 132)["vec"] == 0
    assert N.launch_plan((2, 1, 1, 1), 1, 4, True, 132) is None   # L = 1
    assert N.launch_plan((2, 6, 4, 4), 4, 4, True, 132) is None   # C % G
