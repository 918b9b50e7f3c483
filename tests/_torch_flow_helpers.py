"""Shared helpers of the port's flow-path parity tests: numpy-seeded flax
variables, NHWC <-> NCHW, and a relative comparison."""

import jax
import numpy as np
import torch


def numpy_variables(jmod, *xs, seed=0):
    """``jmod``'s variables (``eval_shape`` of ``init``) from a numpy seed:
    kernels ~ N(0, 1/fan_in), batch-norm scales in [0.5, 1.5), variances
    in [0.3, 2.5), other leaves in [-0.5, 0.5)."""
    shapes = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *xs)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        if key == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.3, 2.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rtol, (what, err)


# one harness step of each package from the same weights and batch: 128²,
# batch 2 (at 64² conv6 is 1x1 and its batch norm over 2 values per channel
# makes the encoders' gradients ill-conditioned: 1e-2 apart in float32)
STEP_SIZE, STEP_BATCH, STEP_LR = 128, 2, 1e-4


def harness_step_pair(model_name, seed=0):
    """(before, JAX after, port after, JAX metrics, port metrics): one
    step of ``jafpro_tpu.train.flow_harness``'s jitted Adam step and of
    the port's, from one numpy-seeded tree on one synthetic batch. Trees
    are flattened flax variables (``params/...``, ``batch_stats/...``)."""
    import jax.numpy as jnp
    import optax

    from jafpro_tpu.models.flownet import FlowNetC, FlowNetSD
    from jafpro_tpu.train import flow_harness as jh

    from jafpro_tpu_torch.bridge import flax_from_state_dict, load_flax
    from jafpro_tpu_torch.checkpoints import flatten
    from jafpro_tpu_torch.train import flow_harness as th

    pairs, flow = jh.synthetic_flow_batch(np.random.RandomState(seed),
                                          STEP_BATCH, STEP_SIZE)
    S, B = STEP_SIZE, STEP_BATCH
    if model_name == "sd":
        v = numpy_variables(FlowNetSD(), jnp.zeros((B, S, S, 6)), seed=seed)
    else:
        v = numpy_variables(FlowNetC(), jnp.zeros((B, S, S, 3)),
                            jnp.zeros((B, S, S, 3)), seed=seed)
    _, jstep = jh.make_flow_train_step(model_name, lr=STEP_LR)
    jstate = {"params": v["params"], "batch_stats": v["batch_stats"],
              "opt": optax.adam(STEP_LR).init(v["params"])}
    jnew, jm = jstep(jstate, pairs, flow)
    init_fn, step_fn = th.make_flow_train_step(model_name, lr=STEP_LR,
                                               device="cpu")
    state = init_fn(torch.Generator().manual_seed(seed))
    load_flax(state.model, v)
    state, tm = step_fn(state, pairs, flow)
    tree = lambda t: flatten(jax.tree_util.tree_map(np.asarray, t))
    return (tree(v), tree({"params": jnew["params"],
                           "batch_stats": jnew["batch_stats"]}),
            flatten(flax_from_state_dict(state.model)),
            {k: float(x) for k, x in jm.items()},
            {k: float(x) for k, x in tm.items()})


def check_harness_step(model_name, zero_grad_params=()):
    """Loss and EPE within 1e-5 relative, ``batch_stats`` within 1e-5
    relative, and each parameter's Adam update entrywise within 1e-2 lr
    but for at most max(1, 0.5%) of its entries. Adam's first step moves
    an entry by lr g / (|g| + 1e-8), about sign(g) lr: an entry whose
    gradient the two packages round to opposite signs moves the other way
    (measured: at most 0.12% of a parameter's entries, or 1 entry).
    ``zero_grad_params`` (a conv bias before a training-mode batch norm,
    whose gradient is zero but for rounding in both packages) are held to
    |update| <= lr only."""
    before, jafter, tafter, jm, tm = harness_step_pair(model_name)
    for k in ("loss", "epe"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm[k], jm[k])
    assert set(tafter) == set(jafter) == set(before)
    moved = 0
    for k, p0 in before.items():
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(tafter[k], jafter[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            continue
        du, dj = tafter[k] - p0, jafter[k] - p0
        if k in zero_grad_params:
            assert np.abs(du).max() <= STEP_LR * (1 + 1e-3), k
            continue
        off = int((np.abs(du - dj) > 1e-2 * STEP_LR).sum())
        assert off <= max(1, 0.005 * du.size), (k, off, du.size)
        moved += int(np.abs(dj).max() > 0.5 * STEP_LR)
    assert moved > len(before) // 3
