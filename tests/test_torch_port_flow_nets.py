"""Port parity for the FlowNet family's nets and losses: ``FlowNetC``,
``FlowNetS`` and ``FlowNetFusion`` (evaluation mode, 64² as
``tests/test_flownet_parity.py`` sizes them), ``FlowNetSD`` and
``FlowNetC`` in training mode (the flow2..flow6 pyramid and flax's update
of ``batch_stats``), ``flownet2_preprocess``, ``epe`` and
``multiscale_flow_loss``, against ``jafpro_tpu.models.flownet`` on the CPU
in float32.

Weights are numpy-seeded flax trees loaded through ``bridge.load_flax``
(batch-norm statistics away from 0 and 1). Tolerances: the nets 1e-4
relative to the largest output magnitude; ``batch_stats`` 1e-5 relative;
the losses 1e-6 relative. The training-mode nets run at 128², batch 2:
at 64² their conv6 is 1×1 and batch norm there normalises 2 values per
channel, which amplifies rounding into the coarsest flows (measured: 7.6e-4
on flow6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.models import flownet as J

from jafpro_tpu_torch.bridge import flax_from_state_dict, load_flax
from jafpro_tpu_torch.checkpoints import flatten
from jafpro_tpu_torch.models import flownet as T

from _torch_flow_helpers import assert_rel, nchw, nhwc, numpy_variables

torch.set_num_threads(1)


@pytest.mark.parametrize("name,cin", [("FlowNetS", 12), ("FlowNetFusion", 11),
                                      ("FlowNetSD", 6)])
def test_single_input_nets_match_jax(name, cin):
    jm, tm = getattr(J, name)(), getattr(T, name)()
    x = np.random.RandomState(cin).rand(2, 64, 64, cin).astype(np.float32)
    v = numpy_variables(jm, jnp.zeros(x.shape), seed=cin)
    load_flax(tm, v)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(x)))
    assert_rel(got, want, 1e-4, name)


def test_flownet_c_matches_jax():
    jm, tm = J.FlowNetC(), T.FlowNetC()
    x = np.random.RandomState(1).rand(2, 64, 64, 6).astype(np.float32)
    v = numpy_variables(jm, jnp.zeros((2, 64, 64, 3)),
                        jnp.zeros((2, 64, 64, 3)), seed=1)
    load_flax(tm, v)
    want = np.asarray(jm.apply(v, jnp.asarray(x[..., :3]),
                               jnp.asarray(x[..., 3:])))
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(x[..., :3]), nchw(x[..., 3:])))
    assert got.shape == (2, 16, 16, 2)
    assert_rel(got, want, 1e-4, "flow2")


@pytest.mark.parametrize("name", ["FlowNetSD", "FlowNetC"])
def test_train_mode_pyramid_and_batch_stats_match_jax(name):
    """``train()`` + ``train_mode``: batch statistics, the five flows and
    the running statistics moved as flax moves them."""
    x = np.random.RandomState(2).rand(2, 128, 128, 6).astype(np.float32)
    jm, tm = getattr(J, name)(), getattr(T, name)()
    if name == "FlowNetSD":
        jx, tx = (jnp.asarray(x),), (nchw(x),)
    else:
        jx = (jnp.asarray(x[..., :3]), jnp.asarray(x[..., 3:]))
        tx = (nchw(x[..., :3]), nchw(x[..., 3:]))
    v = numpy_variables(jm, *(jnp.zeros(a.shape) for a in jx), seed=2)
    load_flax(tm, v)
    want, upd = jm.apply(v, *jx, train=True, train_mode=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(*tx, train_mode=True)
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[-1] == 128 // 4 // 2 ** i
        assert_rel(nhwc(g), w, 1e-4, f"flow{i + 2}")
    got_s = flatten(flax_from_state_dict(tm)["batch_stats"])
    want_s = flatten(jax.tree_util.tree_map(np.asarray,
                                            upd["batch_stats"]))
    assert set(got_s) == set(want_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_flownet2_preprocess_and_losses_match_jax():
    rng = np.random.RandomState(3)
    frames = (rng.rand(2, 16, 24, 3, 2) * 255).astype(np.float32)
    want = np.asarray(J.flownet2_preprocess(jnp.asarray(frames)))
    got = T.flownet2_preprocess(torch.from_numpy(
        np.ascontiguousarray(frames.transpose(0, 3, 4, 1, 2))))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)

    # sizes that 4, 8, ... 64 do not divide: the VALID window mean drops
    # the rows and columns past the last whole window
    target = (rng.randn(2, 70, 100, 2) * 5).astype(np.float32)
    pyr = [(rng.randn(2, 70 // k, 100 // k, 2)).astype(np.float32)
           for k in (4, 8, 16, 32, 64)]
    np.testing.assert_allclose(
        float(T.epe(nchw(pyr[0]), nchw(pyr[0] * 0.5))),
        float(J.epe(jnp.asarray(pyr[0]), jnp.asarray(pyr[0] * 0.5))),
        rtol=1e-6)
    for norm in ("L1", "L2"):
        jl, je = J.multiscale_flow_loss([jnp.asarray(p) for p in pyr],
                                        jnp.asarray(target), norm=norm)
        tl, te = T.multiscale_flow_loss([nchw(p) for p in pyr],
                                        nchw(target), norm=norm)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6,
                                   err_msg=norm)
        np.testing.assert_allclose(float(te), float(je), rtol=1e-6,
                                   err_msg=norm)
