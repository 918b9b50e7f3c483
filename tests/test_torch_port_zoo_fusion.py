"""Port parity of the zoo's texture nets against ``jafpro_tpu`` on the
CPU: ``TorchConvTranspose``, the instance norms, the texture U-Nets, the
fusion ablations over part stacks and the latent-code fusion
(``CodeEncoder``, ``CodeDecoder``, ``MaxFusionModule``, whose flax
``encoders``/``decoders`` are vmapped over the parts with stacked
parameters). Weights are numpy-seeded flax variables carried across by
``bridge.py``; float32 on both sides. Tolerance: within 1e-4 of the
largest output (``NET_RTOL``); the norms within 1e-5 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.models import ablations as ja

from jafpro_tpu_torch.models import ablations as ta

from _torch_zoo_helpers import (
    F32, T32, bridged, close, japply, nchw, nhwc, rand, round_trip)

torch.set_num_threads(1)


@pytest.mark.parametrize("k,s,p", [(3, 2, 0), (4, 2, 1), (3, 1, 1)])
def test_torch_conv_transpose(k, s, p):
    x = rand((2, 5, 6, 4), 0)
    j = ja.TorchConvTranspose(3, k, s, p, dtype=F32)
    t = ta.TorchConvTranspose(4, 3, k, s, p, compute_dtype=T32)
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))


def test_instance_norms():
    x = rand((2, 5, 7, 3), 1, -2, 3)
    want = ja.InstanceNorm().apply({}, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(ta.InstanceNorm()(nchw(x))),
                               np.asarray(want), atol=1e-5, rtol=0)
    code = rand((3, 1, 256), 2, -2, 3)
    want = ja.InstanceNorm1d().apply({}, jnp.asarray(code))
    np.testing.assert_allclose(
        ta.InstanceNorm1d()(torch.from_numpy(code)).numpy(),
        np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,shape", [
    ("UNetSE", (1, 48, 48, 6)),
    ("UNetGenerator", (1, 64, 64, 3)),
    ("UNetTA", (1, 32, 48, 6)),
])
def test_texture_unets(name, shape):
    x = rand(shape, 3)
    j = getattr(ja, name)(dtype=F32)
    t = getattr(ta, name)(cin=shape[-1], compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["AccumulatePlain", "AccumulateMaxFusion",
                                  "AccumulateAvgFusion", "AccumulateMask"])
def test_fusion_ablations(name):
    B, N, P, p = 1, 2, 2, 16
    parts = rand((B, N, P, p, p, 3), 4)
    j = getattr(ja, name)(dtype=F32)
    kw = {"refs": N} if name in ("AccumulatePlain", "AccumulateMask") else {}
    t = getattr(ta, name)(P, compute_dtype=T32, device="cpu", **kw)
    v = bridged(j, t, jnp.asarray(parts))
    close(t(torch.from_numpy(parts)).detach(),
          japply(j, v, jnp.asarray(parts)))


def test_code_encoder_decoder():
    x = rand((2, 200, 200, 3), 5)
    j = ja.CodeEncoder(dtype=F32)
    t = ta.CodeEncoder(compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    code = japply(j, v, jnp.asarray(x))
    close(t(nchw(x)).detach(), code)

    z = np.concatenate([np.asarray(code)] * 2, -1)
    j = ja.CodeDecoder(dtype=F32)
    t = ta.CodeDecoder(compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(z))
    close(nhwc(t(torch.from_numpy(z))), japply(j, v, jnp.asarray(z)))


def test_max_fusion_module():
    """P = 2 parts of 200 px (``Dense_0`` takes P * 256 inputs); each
    encoder layer norm has statistics per sample and per part."""
    B, N, P, p = 1, 2, 2, 200
    parts = rand((B, N, P, p, p, 3), 6)
    j = ja.MaxFusionModule(dtype=F32)
    t = ta.MaxFusionModule(P, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(parts))
    want = japply(j, v, jnp.asarray(parts))
    close(t(torch.from_numpy(parts)).detach(), want)
    round_trip(t, v)
