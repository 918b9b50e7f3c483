"""Port parity: HMR (``models/hmr.py``), ``get_details`` and HMR's bridge
rules against ``jafpro_tpu`` on the CPU, float32.

Tolerances: theta and features within 1e-4 of their largest entry (a
conv stack in float32, two libraries' conv algorithms); ``get_details``
atol 1e-4 (SMPL on that theta); bridged weights round-trip exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from jafpro_tpu.geometry import smpl as jsmpl
from jafpro_tpu.models import hmr as jhmr

from jafpro_tpu_torch import bridge
from jafpro_tpu_torch.geometry import smpl as tsmpl
from jafpro_tpu_torch.models import hmr as thmr

torch.set_num_threads(1)
THETA_RTOL = 1e-4


def randomize_tree(tree, rng):
    """Random values for every leaf (positive batch-norm variances), so the
    comparison exercises every parameter and statistic."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_tree(v, rng)
            continue
        a = np.asarray(v)
        if k == "var":
            out[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = (0.1 * rng.randn(*a.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            out[k] = a.astype(np.float32)
    return out


def jax_hmr(num_blocks, size, seed=0):
    """The JAX HMR at ``num_blocks`` (its encoder and regressor composed
    under the module's names) with randomized variables."""
    enc = jhmr.PreActResNet50(num_blocks=num_blocks)
    reg = jhmr.ThetaRegressor()
    x = jnp.zeros((1, size, size, 3))
    ev = enc.init(jax.random.PRNGKey(seed), x)
    rv = reg.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, 2048)))
    rng = np.random.RandomState(seed)
    variables = {
        "params": randomize_tree({"resnet": ev["params"],
                                  "regressor": rv["params"]}, rng),
        "batch_stats": randomize_tree({"resnet": ev["batch_stats"]}, rng),
    }

    def apply(img):
        v = variables
        f = enc.apply({"params": v["params"]["resnet"],
                       "batch_stats": v["batch_stats"]["resnet"]}, img)
        return f, reg.apply({"params": v["params"]["regressor"]}, f)

    return variables, apply


@pytest.mark.parametrize("size", [64, 67])
def test_hmr_matches_jax(size):
    """(1, 1, 1, 1) blocks; 67 is odd: the stem's padded pool window sets
    the output size, and every stride-2 layer sees an odd input."""
    variables, japply = jax_hmr((1, 1, 1, 1), size)
    m = thmr.HumanModelRecovery(num_blocks=(1, 1, 1, 1), device="cpu")
    bridge.load_flax(m, variables)
    img = np.random.RandomState(size).randn(2, size, size, 3).astype(
        np.float32)
    jf, jt = (np.asarray(a) for a in japply(jnp.asarray(img)))
    with torch.no_grad():
        x = torch.from_numpy(img).permute(0, 3, 1, 2)
        tf = m.resnet(x).numpy()
        tt = m(x).numpy()
    np.testing.assert_allclose(tf, jf, atol=THETA_RTOL * np.abs(jf).max())
    np.testing.assert_allclose(tt, jt, atol=THETA_RTOL * np.abs(jt).max())
    # get_details on the theta of both
    js = jsmpl.SMPLModel.synthetic(num_verts=48, seed=1)
    ts = tsmpl.SMPLModel.synthetic(num_verts=48, seed=1, device="cpu")
    theta = jt * np.float32(0.3)
    jd = jhmr.get_details(js, jnp.asarray(theta))
    td = thmr.get_details(ts, torch.from_numpy(theta))
    assert set(td) == set(jd)
    for k in jd:
        assert td[k].shape == jd[k].shape, k
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                   atol=1e-4, err_msg=k)


def test_hmr_full_depth_matches_jax():
    """The JAX package's own ``HumanModelRecovery`` (full ResNet50 depth)
    at a small input against the port's default."""
    jm = jhmr.HumanModelRecovery()
    img = np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(img))
    rng = np.random.RandomState(2)
    v = {"params": randomize_tree(v["params"], rng),
         "batch_stats": randomize_tree(v["batch_stats"], rng)}
    jt = np.asarray(jm.apply(v, jnp.asarray(img)))
    m = thmr.HumanModelRecovery(device="cpu")
    bridge.load_flax(m, v)
    with torch.no_grad():
        tt = m(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()
    assert tt.shape == (1, 85)
    np.testing.assert_allclose(tt, jt, atol=THETA_RTOL * np.abs(jt).max())


def test_hmr_bridge_round_trip():
    """``flax_from_state_dict`` gives the JAX tree (batch_stats, mean_theta,
    dense kernels) that ``load_flax`` took, and the JAX model runs on it."""
    variables, _ = jax_hmr((1, 1, 1, 1), 32, seed=5)
    m = thmr.HumanModelRecovery(num_blocks=(1, 1, 1, 1), device="cpu")
    bridge.load_flax(m, variables)
    back = bridge.flax_from_state_dict(m)
    assert set(back) == {"params", "batch_stats"}
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(a))
    assert back["params"]["regressor"]["mean_theta"].shape == (85,)
    assert back["params"]["regressor"]["fc1"]["kernel"].shape == (2133, 1024)


def test_hmr_seeded_init_and_bfloat16():
    """Seeded weights are reproducible; bfloat16 compute gives a finite
    theta near float32's."""
    g = lambda: torch.Generator().manual_seed(7)
    a = thmr.HumanModelRecovery((1, 1, 1, 1), device="cpu", generator=g())
    b = thmr.HumanModelRecovery((1, 1, 1, 1), compute_dtype=torch.bfloat16,
                                device="cpu", generator=g())
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 64, 64).astype(
        np.float32))
    with torch.no_grad():
        ta, tb = a(x), b(x)
    assert tb.dtype == torch.float32 and torch.isfinite(tb).all()
    assert (ta - tb).abs().max() <= 0.05 * ta.abs().max()
