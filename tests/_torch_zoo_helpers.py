"""Shared set-up of the ablation-zoo parity tests
(``tests/test_torch_port_zoo_*.py``): numpy-seeded flax variables of a
JAX module's own tree, carried into the port by ``bridge.load_flax``; both
packages run the same numpy-seeded input in float32 (flax ``dtype``
float32, the port's ``compute_dtype`` float32) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jafpro_tpu_torch.bridge import flax_from_state_dict, load_flax

F32 = jnp.float32
T32 = torch.float32
NET_RTOL = 1e-4   # nets: within 1e-4 of the largest output
SN_ATOL = 1e-5    # spectral-norm u and sigma after update_sn=True


def rand(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def nchw(a):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def numpy_variables(jmod, *jargs, seed=0, static=(), **kw):
    """All of ``jmod``'s variables (params and batch_stats) from a numpy
    seed: kernels ~ N(0, 1/fan_in) (fan_in of one part where flax stacks
    parts), every other leaf uniform in [-0.5, 0.5) (non-zero biases,
    norm affines and spectral-norm state). Only the tree's shapes come
    from flax (``eval_shape``). ``static``: positions of ``jargs`` that
    are not arrays; ``kw`` go to ``init`` as they are."""
    arrays = [a for i, a in enumerate(jargs) if i not in static]

    def init(*arrs):
        it = iter(arrs)
        args = [jargs[i] if i in static else next(it)
                for i in range(len(jargs))]
        return jmod.init(jax.random.PRNGKey(0), *args, **kw)

    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            shape = leaf.shape
            fan_in = int(np.prod(shape[-4:-1] if len(shape) >= 4
                                 else shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(init, *arrays)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def bridged(jmod, tmod, *jargs, seed=0, static=(), **kw):
    """Numpy-seeded variables for ``jmod``, loaded into ``tmod`` through
    the bridge; returns them (plain dicts of numpy arrays)."""
    variables = jax.tree_util.tree_map(np.asarray, numpy_variables(
        jmod, *jargs, seed=seed, static=static, **kw))
    variables = {k: dict(v) for k, v in variables.items()}
    load_flax(tmod, variables)
    return variables


def japply(jmod, variables, *args, static=(), **kw):
    fn = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw),
                 static_argnums=tuple(s + 1 for s in static))
    return fn(variables, *args)


def close(got, want, rtol=NET_RTOL):
    """Within ``rtol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def round_trip(tmod, variables):
    """state_dict -> flax tree -> state_dict: the tree equals the one
    loaded, leaf for leaf, and loads back to the same state_dict."""
    got, want = leaves(flax_from_state_dict(tmod)), leaves(variables)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    load_flax(tmod, flax_from_state_dict(tmod))
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, before[k]), k
