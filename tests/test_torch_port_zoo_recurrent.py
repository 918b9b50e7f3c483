"""Port parity of the zoo's recurrences and CRNs against ``jafpro_tpu`` on
the CPU: ``reflect_pad``, the single-layer ``ConvLSTM`` and ``ConvGRU``
(both cells, masked steps), ``CRN`` and ``CRNSmall``, and
``AccumulateGRU`` (flax vmaps its one-part networks over the parts with
stacked parameters; the port runs them grouped). Weights are numpy-seeded
flax variables carried across by ``bridge.py``; float32 on both sides.
Tolerance: within 1e-4 of the largest output (``NET_RTOL``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.models import accumulate as jacc
from jafpro_tpu.models import common as jcommon
from jafpro_tpu.models import conv_lstm as jlstm
from jafpro_tpu.models import crn as jcrn

from jafpro_tpu_torch.models import accumulate as tacc
from jafpro_tpu_torch.models import common as tcommon
from jafpro_tpu_torch.models import conv_lstm as tlstm
from jafpro_tpu_torch.models import crn as tcrn

from _torch_zoo_helpers import (
    F32, T32, bridged, close, japply, nchw, nhwc, rand, round_trip)

torch.set_num_threads(1)


def seq_nchw(xs):
    """(B, T, H, W, C) numpy -> (B, T, C, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(xs, -1, 2)))


def seq_nhwc(t):
    return np.moveaxis(t.detach().numpy(), 2, -1)


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad(pad):
    x = rand((2, 7, 9, 3), 0)
    got = tcommon.reflect_pad(nchw(x), pad)
    np.testing.assert_array_equal(nhwc(got), np.asarray(
        jcommon.reflect_pad(jnp.asarray(x), pad)))


MASK = np.array([[1, 0, 1, 1], [1, 1, 0, 1]], np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_conv_lstm(masked):
    xs = rand((2, 4, 8, 8, 3), 1)
    mask = MASK if masked else None
    args = [jnp.asarray(xs)] + ([jnp.asarray(mask)] if masked else [])
    j = jlstm.ConvLSTM(5, dtype=F32)
    t = tlstm.ConvLSTM(3, 5, compute_dtype=T32, device="cpu")
    v = bridged(j, t, *args)
    ys, (h, c) = japply(j, v, *args)
    tys, (th, tc) = t(seq_nchw(xs),
                      None if mask is None else torch.from_numpy(mask))
    close(seq_nhwc(tys), ys)
    close(nhwc(th), h)
    close(nhwc(tc), c)


@pytest.mark.parametrize("cell", ["gru", "modgru"])
@pytest.mark.parametrize("masked", [False, True])
def test_conv_gru(cell, masked):
    xs = rand((2, 4, 8, 8, 3), 2)
    mask = MASK if masked else None
    args = [jnp.asarray(xs)] + ([jnp.asarray(mask)] if masked else [])
    j = jlstm.ConvGRU(6, cell=cell, dtype=F32)
    t = tlstm.ConvGRU(3, 6, cell=cell, compute_dtype=T32, device="cpu")
    v = bridged(j, t, *args)
    ys, h = japply(j, v, *args)
    tys, th = t(seq_nchw(xs),
                None if mask is None else torch.from_numpy(mask))
    close(seq_nhwc(tys), ys)
    close(nhwc(th), h)
    if masked:   # a masked step leaves the state as it was
        np.testing.assert_array_equal(tys[0, 1].detach().numpy(),
                                      tys[0, 0].detach().numpy())


@pytest.mark.parametrize("name", ["CRN", "CRNSmall"])
def test_crn(name):
    S = 64
    x = rand((1, S, S, 3), 3)
    j = getattr(jcrn, name)(fg=True, dtype=F32)
    t = getattr(tcrn, name)(fg=True, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x), S, static=(1,))
    out, mask = japply(j, v, jnp.asarray(x), S, static=(1,))
    tout, tmask = t(nchw(x), S)
    close(nhwc(tout), out)
    close(nhwc(tmask), mask)


def test_crn_smaller_keeps_its_names():
    """``CRNSmaller`` is the pipeline's: a setting of the shared base with
    the state_dict layout it always had."""
    t = tcrn.CRNSmaller(fg=True)
    keys = list(t.state_dict())
    assert keys[:4] == ["ConvBlock_0.Conv_0.weight", "ConvBlock_0.Conv_0.bias",
                        "ConvBlock_0.SampleLayerNorm_0.gamma",
                        "ConvBlock_0.SampleLayerNorm_0.beta"]
    assert keys[-4:] == ["Conv_0.weight", "Conv_0.bias", "Conv_1.weight",
                         "Conv_1.bias"]
    assert len(keys) == 13 * 2 * 4 + 4
    assert t.ConvBlock_2.Conv_0.weight.shape == (128, 128, 3, 3)
    assert isinstance(t, tcrn._CRNBase)


@pytest.mark.parametrize("cell", ["gru", "modgru"])
def test_accumulate_gru(cell):
    B, N, P, p = 1, 2, 2, 16
    parts = rand((B, N, P, p, p, 3), 4)
    mask = np.array([[1.0, 0.0]], np.float32)
    j = jacc.AccumulateGRU(cell=cell, dtype=F32)
    t = tacc.AccumulateGRU(P, cell=cell, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(parts), jnp.asarray(mask))
    want = japply(j, v, jnp.asarray(parts), jnp.asarray(mask))
    close(t(torch.from_numpy(parts), torch.from_numpy(mask)).detach(), want)
    # stacked per-part leaves back to flax's layout
    round_trip(t, v)
