"""Port parity of the zoo's ESRGAN/EDSR blocks and CRN extras against
``jafpro_tpu`` on the CPU: ``EDSRResBlock``, ``ResidualDenseBlock5C``,
``RRDB``, ``AutoEncoder``, ``CRNAuto`` and ``SpatioTempoCRN`` (its
flow-warped cross-stream features through the port's border
``grid_sample``, ``resize_nearest`` and align-corners
``resize_bilinear``). Weights are numpy-seeded flax variables carried
across by ``bridge.py``; float32 on both sides. Tolerance: within 1e-4 of
the largest output (``NET_RTOL``)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from jafpro_tpu.models import ablations as ja

from jafpro_tpu_torch.models import ablations as ta

from _torch_zoo_helpers import (
    F32, T32, bridged, close, japply, nchw, nhwc, rand)

torch.set_num_threads(1)


@pytest.mark.parametrize("name,args", [
    ("EDSRResBlock", (8, 0.5)),
    ("ResidualDenseBlock5C", (8, 4)),
    ("RRDB", (8, 4)),
])
def test_esrgan_blocks(name, args):
    x = rand((1, 16, 16, 8), 0)
    j = getattr(ja, name)(*args, dtype=F32)
    t = getattr(ta, name)(*args, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))


def test_auto_encoder_and_crn_auto():
    src = rand((1, 64, 64, 3), 1)
    j = ja.AutoEncoder(dtype=F32)
    t = ta.AutoEncoder(compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(src))
    close(nhwc(t(nchw(src))), japply(j, v, jnp.asarray(src)))

    S = 64
    label = rand((1, S, S, 6), 2)
    j = ja.CRNAuto(dtype=F32)
    t = ta.CRNAuto(compute_dtype=T32, device="cpu")
    args = (jnp.asarray(label), S, jnp.asarray(src))
    v = bridged(j, t, *args, static=(1,))
    close(nhwc(t(nchw(label), S, nchw(src))),
          japply(j, v, *args, static=(1,)))


@pytest.fixture(scope="module")
def spatio_tempo_crn():
    """SpatioTempoCRN at ngf 32, 64², both packages, bridged weights and
    one jitted JAX apply shared by the flow cases."""
    S = 64
    label, prev = rand((1, S, S, 6), 3), rand((1, S, S, 6), 4)
    j = ja.SpatioTempoCRN(ngf=32, dtype=F32)
    t = ta.SpatioTempoCRN(ngf=32, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(label), jnp.asarray(prev), S,
                jnp.zeros((1, S, S, 2)), static=(2,))
    fn = jax.jit(lambda v, a, b, f: j.apply(v, a, b, S, f))
    return S, label, prev, t, v, fn


@pytest.mark.parametrize("flow_scale", [0.0, 0.05])
def test_spatio_tempo_crn(spatio_tempo_crn, flow_scale):
    S, label, prev, t, v, fn = spatio_tempo_crn
    flow = flow_scale * rand((1, S, S, 2), 5)
    out, prev_out = fn(v, jnp.asarray(label), jnp.asarray(prev),
                       jnp.asarray(flow))
    tout, tprev = t(nchw(label), nchw(prev), S, nchw(flow))
    close(nhwc(tout), out)
    close(nhwc(tprev), prev_out)
