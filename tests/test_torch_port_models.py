"""Port parity: the texture, CRN and propagation nets of
``jafpro_tpu_torch`` against ``jafpro_tpu`` on the CPU.

Each flax module gets numpy-seeded params of its own tree structure, which
go through ``jafpro_tpu_torch.bridge`` to the port, and both run the same numpy-seeded input in
float32 at small size (few parts, 16-32 px). Tolerance atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.models import accumulate as jacc
from jafpro_tpu.models import common as jcommon
from jafpro_tpu.models import conv_lstm as jlstm
from jafpro_tpu.models import crn as jcrn
from jafpro_tpu.models import inpainter as jinp
from jafpro_tpu.models import parts as jparts
from jafpro_tpu.models import propagation as jprop

from jafpro_tpu_torch.bridge import load_flax
from jafpro_tpu_torch.models import accumulate as tacc
from jafpro_tpu_torch.models import common as tcommon
from jafpro_tpu_torch.models import conv_lstm as tlstm
from jafpro_tpu_torch.models import crn as tcrn
from jafpro_tpu_torch.models import inpainter as tinp
from jafpro_tpu_torch.models import parts as tparts
from jafpro_tpu_torch.models import propagation as tprop

torch.set_num_threads(1)
ATOL = 1e-4
F32 = jnp.float32


def nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(a, -1, 1), order="C"))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def numpy_params(jmod, *jargs, seed=0, static=()):
    """A param tree of ``jmod``'s structure filled from a numpy seed:
    kernels ~ N(0, 1/fan_in), every other leaf uniform in [-0.5, 0.5)
    (non-zero biases and norm affines, unlike a fresh init). Only the
    tree's shapes come from flax (``eval_shape``: nothing is compiled).
    ``static``: positions of ``jargs`` that are not arrays."""
    arrays = [a for i, a in enumerate(jargs) if i not in static]

    def init(*arrs):
        it = iter(arrs)
        args = [jargs[i] if i in static else next(it)
                for i in range(len(jargs))]
        return jmod.init(jax.random.PRNGKey(0), *args)

    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[1:-1] if len(leaf.shape) == 5
                                 else leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(init, *arrays))


def bridged(jmod, tmod, *jargs, seed=0, static=()):
    """Numpy-seeded params for ``jmod``, loaded into ``tmod`` through the
    bridge."""
    params = numpy_params(jmod, *jargs, seed=seed, static=static)
    load_flax(tmod, params)
    return params


def japply(jmod, params, *args, static=()):
    return jax.jit(jmod.apply, static_argnums=static)(params, *args)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def rand(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_conv_lrelu_and_upsample():
    x = rand((2, 9, 9, 5))
    j = jcommon.ConvLReLU(7, kernel=3, stride=2, dtype=F32)
    t = tcommon.ConvLReLU(5, 7, kernel=3, stride=2)
    p = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, p, jnp.asarray(x)))

    skip = rand((2, 12, 12, 4), 1)
    j = jcommon.UpsampleConvLReLU(6, 12, dtype=F32)
    t = tcommon.UpsampleConvLReLU(5, 4, 6, 12)
    p = bridged(j, t, jnp.asarray(x), jnp.asarray(skip))
    close(nhwc(t(nchw(x), nchw(skip))),
          japply(j, p, jnp.asarray(x), jnp.asarray(skip)))


def test_layer_norm_conv_block_reflect_conv():
    x = rand((2, 8, 8, 6), 2, 0, 3)
    j = jcommon.SampleLayerNorm(6)
    t = tcommon.SampleLayerNorm(6)
    p = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, p, jnp.asarray(x)))

    j = jcommon.ConvBlock(2, 8, dtype=F32)
    t = tcommon.ConvBlock(2, 6, 8)
    p = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, p, jnp.asarray(x)))

    j = jcommon.ReflectConv(4, kernel=7, dtype=F32)
    t = tcommon.ReflectConv(6, 4, kernel=7)
    p = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, p, jnp.asarray(x)))


@pytest.mark.parametrize("impl", ["dense", "groups", "blocks2"])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (5, 1), (3, 2)])
def test_part_conv(impl, kernel, stride):
    P, cin, cout = 4, 3, 5
    x = rand((2, 10, 10, P * cin), 3)
    j = jparts.PartConv(P, cout, kernel=kernel, stride=stride, impl=impl,
                        dtype=F32)
    t = tparts.PartConv(P, cin, cout, kernel=kernel, stride=stride)
    p = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, p, jnp.asarray(x)))


def test_group_conv_multi_input_and_packing():
    P = 3
    a, b = rand((2, 6, 6, P * 4), 4), rand((2, 6, 6, P * 2), 5)
    j = jparts.GroupConvLReLU(P, 5, dtype=F32)
    t = tparts.GroupConvLReLU(P, [4, 2], 5)
    p = bridged(j, t, jnp.asarray(a), jnp.asarray(b))
    close(nhwc(t(nchw(a), nchw(b))), japply(j, p, jnp.asarray(a),
                                             jnp.asarray(b)))
    close(nhwc(tparts.part_cat(nchw(a), nchw(b), P)),
          jparts.part_cat(jnp.asarray(a), jnp.asarray(b), P), atol=0)

    parts = rand((2, P, 5, 7, 3), 6)
    packed = tparts.pack_parts(torch.from_numpy(parts))
    close(nhwc(packed), jparts.pack_parts(jnp.asarray(parts)), atol=0)
    close(tparts.unpack_parts(packed, P), parts, atol=0)


def test_part_encoder_decoder():
    P = 2
    x = rand((2, 16, 16, P * 3), 7)
    j = jparts.PartEncoder(parts=P, dtype=F32)
    t = tparts.PartEncoder(P)
    p = bridged(j, t, jnp.asarray(x))
    jskips = japply(j, p, jnp.asarray(x))
    tskips = t(nchw(x))
    for a, b in zip(tskips, jskips):
        close(nhwc(a), b)

    skips = [np.asarray(s) for s in jskips]
    j = jparts.PartDecoder(parts=P, dtype=F32)
    t = tparts.PartDecoder(P)
    p = bridged(j, t, tuple(jnp.asarray(s) for s in skips))
    close(nhwc(t(tuple(nchw(s) for s in skips))),
          japply(j, p, tuple(jnp.asarray(s) for s in skips)))


def test_grouped_conv_lstm_masked():
    P, C, D, T = 2, 3, 4, 3
    xs = rand((2, T, 6, 6, P * C), 8)
    mask = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
    j = jlstm.GroupedConvLSTM(P, D, dtype=F32)
    t = tlstm.GroupedConvLSTM(P, C, D)
    p = bridged(j, t, jnp.asarray(xs), jnp.asarray(mask))
    got = t(torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(xs, -1, 2))), torch.from_numpy(mask))
    close(nhwc(got), japply(j, p, jnp.asarray(xs), jnp.asarray(mask)))


def test_accumulate_lstm():
    B, N, P, p = 1, 2, 3, 16
    parts = rand((B, N, P, p, p, 3), 9)
    mask = np.array([[1.0, 0.0]], np.float32)
    j = jacc.AccumulateLSTM(conv_impl="groups", dtype=F32)
    t = tacc.AccumulateLSTM(P)
    pr = bridged(j, t, jnp.asarray(parts), jnp.asarray(mask))
    close(t(torch.from_numpy(parts), torch.from_numpy(mask)).detach(),
          japply(j, pr, jnp.asarray(parts), jnp.asarray(mask)))


def test_unet_inpainter():
    P, p = 3, 16
    parts = rand((2, P, p, p, 3), 10)
    j = jinp.UNetInpainter(conv_impl="dense", dtype=F32)
    t = tinp.UNetInpainter(P)
    pr = bridged(j, t, jnp.asarray(parts))
    close(t(torch.from_numpy(parts)).detach(),
          japply(j, pr, jnp.asarray(parts)))


@pytest.mark.parametrize("fg", [False, True])
def test_crn_smaller(fg):
    S = 32
    x = rand((2, S, S, 3), 11)
    j = jcrn.CRNSmaller(fg=fg, dtype=F32)
    t = tcrn.CRNSmaller(fg=fg)
    p = bridged(j, t, jnp.asarray(x), S, static=(1,))
    want = japply(j, p, jnp.asarray(x), S, static=(2,))
    got = t(nchw(x), S)
    if fg:
        close(nhwc(got[0]), want[0])
        close(nhwc(got[1]), want[1])
    else:
        close(nhwc(got), want)


@pytest.mark.parametrize("per_sample", [False, True])
def test_propagation(per_sample):
    S = 32
    fake, tsf, iuv = (rand((2, S, S, 3), s) for s in (12, 13, 14))
    mask = (rand((2, S, S, 1), 15, 0, 1) > 0.3).astype(np.float32)
    args = [jnp.asarray(a) for a in (fake, tsf, iuv, mask)]
    j = jprop.Propagation3DFlowNet(per_sample_norm=per_sample, dtype=F32)
    t = tprop.Propagation3DFlowNet()
    p = bridged(j, t, *args)
    want = japply(j, p, *args)
    got = t(*(nchw(a) for a in (fake, tsf, iuv, mask)),
            per_sample_norm=per_sample)
    close(nhwc(got["pred_target"]), want["pred_target"])
    close(nhwc(got["weight"]), want["weight"])


def test_init_matches_flax_statistics():
    """The port's own init draws what flax's default initialisers draw:
    truncated-normal kernels of variance 1/fan_in, zero biases,
    LayerNorm gamma in [0, 1)."""
    g = torch.Generator().manual_seed(0)
    net = tcommon.init_params_(tcommon.ConvBlock(2, 64, 128), g)
    w = net.Conv_1.weight.detach()
    fan_in = 128 * 9
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.02
    assert w.abs().max().item() <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert (net.Conv_0.bias == 0).all()
    gamma = net.SampleLayerNorm_0.gamma.detach()
    assert (gamma >= 0).all() and (gamma < 1).all()
    again = tcommon.init_params_(tcommon.ConvBlock(2, 64, 128),
                                 torch.Generator().manual_seed(0))
    assert torch.equal(again.Conv_1.weight, net.Conv_1.weight)


def test_bf16_compute_dtype_casts_convs():
    x = nchw(rand((1, 8, 8, 4), 16))
    t = tcommon.ConvBlock(1, 4, 6, compute_dtype=torch.bfloat16)
    tcommon.init_params_(t, torch.Generator().manual_seed(0))
    y = t(x.bfloat16())
    assert y.dtype == torch.bfloat16
    ref = tcommon.ConvBlock(1, 4, 6)
    ref.load_state_dict(t.state_dict())
    close(y.float().detach(), ref(x).detach(), atol=5e-2)
