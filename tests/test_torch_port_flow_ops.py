"""Port parity for the flow path's ops: ``correlation_reference`` (the
plain form of the correlation kernel) and its backward against
``jafpro_tpu.ops.correlation`` and ``jax.grad``; the backward kernel's
gathers in plain form (``correlation_backward_reference``); ``resample2d``;
and ``FlaxBatchNorm2d`` (FlowNet's and HMR's batch norm) against flax's
``nn.BatchNorm`` in training mode, running statistics included.

Inputs are numpy-seeded, float32 unless a test says otherwise. Tolerances:
1e-6 absolute on the correlation (channel means of unit-normal products),
1e-5 relative L2 on its gradients, 1e-5 absolute on the warps, 1e-5
relative on batch norm.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.models import hmr as jhmr
from jafpro_tpu.ops.correlation import correlation as j_corr
from jafpro_tpu.ops.sampling import resample2d as j_resample2d

from jafpro_tpu_torch.bridge import flax_from_state_dict, load_flax
from jafpro_tpu_torch.models import hmr as thmr
from jafpro_tpu_torch.models.common import FlaxBatchNorm2d
from jafpro_tpu_torch.ops import correlation as tc
from jafpro_tpu_torch.ops.sampling import resample2d

torch.set_num_threads(1)

# (B, C, H, W, max_displacement, stride2): FlowNetC's window on odd sizes
# smaller and larger than it, and a dense stride-1 window
CASES = [(2, 5, 7, 9, 20, 2), (1, 3, 13, 29, 20, 2), (2, 4, 23, 11, 2, 1),
         (1, 6, 9, 10, 4, 1)]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def features(case, seed):
    B, C, H, W, _, _ = case
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, H, W, C).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_correlation_reference_matches_jax(case):
    md, s2 = case[4:]
    a, b = features(case, 0)
    want = np.asarray(j_corr(jnp.asarray(a), jnp.asarray(b), md, s2))
    got = tc.correlation_reference(nchw(a), nchw(b), md, s2)
    n = tc.window(md, s2)
    assert got.shape == (case[0], n * n, case[2], case[3])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)
    # on the CPU the wrapper is the plain version and launches nothing
    before = tc.correlation.launches
    torch.testing.assert_close(tc.correlation(nchw(a), nchw(b), md, s2), got,
                               rtol=0, atol=0)
    assert tc.correlation.launches == before


@pytest.mark.parametrize("case", CASES)
def test_correlation_gradients_match_jax(case):
    """Autograd of the plain version against ``jax.grad``, and the backward
    kernel's gathers (plain form) against both, 1e-5 relative L2."""
    md, s2 = case[4:]
    a, b = features(case, 1)
    n = tc.window(md, s2)
    g = np.random.RandomState(2).randn(case[0], case[2], case[3],
                                       n * n).astype(np.float32)
    ja, jb = jax.grad(lambda x, y: jnp.sum(j_corr(x, y, md, s2) * g),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = nchw(a).requires_grad_(), nchw(b).requires_grad_()
    ga, gb = torch.autograd.grad(tc.correlation_reference(ta, tb, md, s2),
                                 (ta, tb), nchw(g))
    ka, kb = tc.correlation_backward_reference(nchw(g), nchw(a), nchw(b),
                                               md, s2)
    for got in ((ga, gb), (ka, kb)):
        assert rel_l2(got[0].permute(0, 2, 3, 1), ja) <= 1e-5
        assert rel_l2(got[1].permute(0, 2, 3, 1), jb) <= 1e-5


def test_correlation_bfloat16_mirrors_jax():
    """bfloat16 inputs: products and mean in float32, one rounding to
    bfloat16, as XLA runs the JAX scan; held to JAX within one bfloat16
    step of each output (measured: equal)."""
    case = CASES[0]
    md, s2 = case[4:]
    a, b = features(case, 3)
    want = np.asarray(j_corr(jnp.asarray(a, jnp.bfloat16),
                             jnp.asarray(b, jnp.bfloat16), md, s2),
                      np.float32)
    got = tc.correlation_reference(nchw(a).bfloat16(), nchw(b).bfloat16(),
                                   md, s2)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all()


def test_correlation_refuses_bad_arguments():
    a = torch.zeros(1, 2, 5, 5)
    with pytest.raises(ValueError, match="multiple of stride2"):
        tc.correlation(a, a, 5, 2)
    with pytest.raises(ValueError, match="one shape"):
        tc.correlation(a, torch.zeros(1, 2, 5, 6), 2, 1)
    with pytest.raises(ValueError, match="dtype"):
        tc.correlation(a, a.double(), 2, 1)
    with pytest.raises(ValueError, match="CUDA"):   # the kernel's wrapper
        tc.correlation_cuda(a, a, 2, 1)


@pytest.mark.parametrize("H,W,scale", [(8, 8, 1.5), (7, 12, 4.0),
                                       (16, 5, 0.3)])
def test_resample2d_matches_jax(H, W, scale):
    rng = np.random.RandomState(H * W)
    img = rng.rand(2, H, W, 3).astype(np.float32)
    flow = (rng.randn(2, H, W, 2) * scale).astype(np.float32)
    want = np.asarray(j_resample2d(jnp.asarray(img), jnp.asarray(flow)))
    got = resample2d(nchw(img), nchw(flow)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def bn_variables(c, seed):
    rng = np.random.RandomState(seed)
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32)},
            "batch_stats": {
                "mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (4, 1, 1, 7), (1, 1, 1, 5)])
def test_flax_batch_norm_matches_flax(shape):
    """Training mode: the output (float32, from a bfloat16 input too) and
    flax's update of the running statistics by the biased batch variance;
    evaluation mode reads them."""
    B, H, W, C = shape
    v = bn_variables(C, 0)
    x = (np.random.RandomState(1).randn(*shape) * 3 + 1).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False)
    want, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = FlaxBatchNorm2d(C)
    load_flax(tm, v)
    got = tm.train()(nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = flax_from_state_dict(tm)["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(
            upd["batch_stats"][k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert FlaxBatchNorm2d(C)(nchw(x).bfloat16()).dtype == torch.float32
    ev = np.asarray(fnn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]},
        jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ev, rtol=1e-5, atol=1e-5)


def test_hmr_training_batch_stats_match_flax():
    """HMR in training mode (a 1-block-per-layer ResNet at 64²) moves its
    running statistics as flax does. Before ``FlaxBatchNorm2d`` it used
    ``nn.BatchNorm2d``, whose unbiased update left every ``var`` off by up
    to N/(N-1) of the step (ROADMAP.md Queue C)."""
    blocks = (1, 1, 1, 1)
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    jm = jhmr.PreActResNet50(num_blocks=blocks)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a),
                            jnp.asarray(x))
    rng = np.random.RandomState(3)

    def fill(path, leaf):
        key = path[-1].key
        if key == "kernel":
            return rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5,
                              leaf.shape).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = thmr.PreActResNet50(num_blocks=blocks)
    load_flax(tm, v)
    got = tm.train()(nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    got_s = flax_from_state_dict(tm)["batch_stats"]
    want_s = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    flat_w = jax.tree_util.tree_leaves_with_path(want_s)
    assert len(flat_w) == 2 * (3 * sum(blocks) + 1)
    for path, w in flat_w:
        node = got_s
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
