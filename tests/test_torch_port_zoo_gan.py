"""Port parity of the zoo's image GANs against ``jafpro_tpu`` on the CPU:
vid2vid's resblock, ``PredictiveModule`` (its stride-2 SAME transposed
convs) and ``BlendingModule``; EdgeConnect's resblock, generators and
discriminator, with flax's ``nn.SpectralNorm`` state (``u``, ``sigma``)
read, run and updated; pix2pix's discriminators and ``lsgan_loss``.
Weights are numpy-seeded flax variables carried across by ``bridge.py``;
float32 on both sides. Tolerances: nets within 1e-4 of the largest
output (``NET_RTOL``); spectral-norm ``u`` and ``sigma`` after
``update_sn=True`` within 1e-5 (``SN_ATOL``); ``lsgan_loss`` exact."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.models import ablations as ja

from jafpro_tpu_torch.bridge import flax_from_state_dict
from jafpro_tpu_torch.models import ablations as ta
from jafpro_tpu_torch.models.common import ConvTranspose2d

from _torch_zoo_helpers import (
    F32, SN_ATOL, T32, bridged, close, japply, leaves, nchw, nhwc, rand,
    round_trip)

torch.set_num_threads(1)


def test_vid2vid_resnet_block_and_blending():
    x = rand((1, 16, 16, 8), 0)
    j = ja.Vid2VidResnetBlock(8, dtype=F32)
    t = ta.Vid2VidResnetBlock(8, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))

    a, b, c = (rand((1, 16, 16, 3), s) for s in (1, 2, 3))
    j = ja.BlendingModule(dtype=F32)
    t = ta.BlendingModule(compute_dtype=T32, device="cpu")
    v = bridged(j, t, *map(jnp.asarray, (a, b, c)))
    close(nhwc(t(nchw(a), nchw(b), nchw(c))),
          japply(j, v, *map(jnp.asarray, (a, b, c))))


@pytest.mark.parametrize("size", [16, 24])
def test_predictive_module(size):
    x = rand((1, size, size, 9), 4)
    j = ja.PredictiveModule(n_blocks=1, dtype=F32)
    t = ta.PredictiveModule(n_blocks=1, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))


def test_same_transposed_conv_is_not_torch_output_padding():
    """flax's 3x3 stride-2 SAME transposed conv equals the port's
    (unpadded, last row and column dropped); torch's
    ``padding=1, output_padding=1``, which gives the same size, does not."""
    x = rand((1, 5, 5, 4), 5)
    j = fnn.ConvTranspose(3, (3, 3), strides=(2, 2), padding="SAME",
                          dtype=F32)
    t = ConvTranspose2d(4, 3, 3, 2, crop_end=1, compute_dtype=T32)
    v = bridged(j, t, jnp.asarray(x))
    want = np.asarray(japply(j, v, jnp.asarray(x)))
    close(nhwc(t(nchw(x))), want)
    torch_idiom = torch.nn.ConvTranspose2d(4, 3, 3, 2, padding=1,
                                           output_padding=1)
    torch_idiom.load_state_dict(t.state_dict())
    got = nhwc(torch_idiom(nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 100 * 1e-4 * np.abs(want).max()


def test_edgeconnect_resnet_block():
    x = rand((1, 12, 12, 8), 6)
    for spectral in (False, True):
        j = ja.EdgeConnectResnetBlock(8, spectral=spectral, dtype=F32)
        t = ta.EdgeConnectResnetBlock(8, spectral=spectral,
                                      compute_dtype=T32, device="cpu")
        v = bridged(j, t, jnp.asarray(x))
        close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))


def test_inpaint_generator():
    x = rand((1, 32, 32, 6), 7)
    j = ja.InpaintGenerator(residual_blocks=2, dtype=F32)
    t = ta.InpaintGenerator(residual_blocks=2, compute_dtype=T32,
                            device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))


def sn_state(variables):
    return {k: a for k, a in leaves(variables).items()
            if k.startswith("['batch_stats']")}


@pytest.mark.parametrize("name,shape", [
    ("EdgeGenerator", (1, 32, 32, 3)),
    ("PatchDiscriminator70", (1, 32, 32, 3)),
])
def test_spectral_norm_nets(name, shape):
    """Forward without and with ``update_sn``: outputs within NET_RTOL,
    the updated ``u`` and ``sigma`` within SN_ATOL of flax's."""
    x = rand(shape, 8)
    kw = {"residual_blocks": 1} if name == "EdgeGenerator" else {}
    j = getattr(ja, name)(dtype=F32, **kw)
    t = getattr(ta, name)(compute_dtype=T32, device="cpu", **kw)
    v = bridged(j, t, jnp.asarray(x))
    round_trip(t, v)

    def outs(o):
        return [o] if name == "EdgeGenerator" else [o[0], *o[1]]

    want = japply(j, v, jnp.asarray(x))
    for a, b in zip(outs(t(nchw(x))), outs(want)):
        close(nhwc(a), b)
    # without update_sn the stored state stays as it was
    for k, a in sn_state(flax_from_state_dict(t)).items():
        np.testing.assert_array_equal(a, sn_state(v)[k])

    want, new = japply(j, v, jnp.asarray(x), update_sn=True,
                       mutable=["batch_stats"])
    got = t(nchw(x), update_sn=True)
    for a, b in zip(outs(got), outs(want)):
        close(nhwc(a), b)
    new_state = sn_state({"batch_stats": new["batch_stats"]})
    got_state = sn_state(flax_from_state_dict(t))
    assert new_state.keys() == got_state.keys() and len(new_state) >= 5
    for k, a in new_state.items():
        assert not np.array_equal(a, sn_state(v)[k]), k
        np.testing.assert_allclose(got_state[k], a, atol=SN_ATOL, rtol=0,
                                   err_msg=k)


def test_pix2pix_discriminators():
    x = rand((1, 32, 32, 3), 9)
    j = ja.NLayerDiscriminator(ndf=16, dtype=F32)
    t = ta.NLayerDiscriminator(ndf=16, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))

    j = ja.PixelDiscriminator(ndf=16, dtype=F32)
    t = ta.PixelDiscriminator(ndf=16, compute_dtype=T32, device="cpu")
    v = bridged(j, t, jnp.asarray(x))
    close(nhwc(t(nchw(x))), japply(j, v, jnp.asarray(x)))


@pytest.mark.parametrize("real", [True, False])
def test_lsgan_loss(real):
    """Exact where the float32 sum of squares is exact (predictions on a
    grid of 1/8: each square a multiple of 1/64), so only the final
    division rounds, as in ``jnp.mean``. On arbitrary floats the two
    libraries sum in different orders: within 1e-6 relative there."""
    grid = np.random.RandomState(10).randint(-8, 9, (2, 5, 5, 1)) / 8.0
    pred = grid.astype(np.float32)
    want = np.asarray(ja.lsgan_loss(jnp.asarray(pred), real))
    np.testing.assert_array_equal(ta.lsgan_loss(nchw(pred), real).numpy(),
                                  want)
    pred = rand((2, 5, 5, 1), 11)
    want = np.asarray(ja.lsgan_loss(jnp.asarray(pred), real))
    np.testing.assert_allclose(ta.lsgan_loss(nchw(pred), real).numpy(),
                               want, rtol=1e-6, atol=0)
