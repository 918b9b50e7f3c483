"""Shared set-up of the port's training-step parity tests: one small
configuration (64 px, 24 parts of 16 px, 2 refs, 16 px faces, batch 2,
float32) built in both packages from the same numpy-seeded param tree,
and one step of a stage run with SGD (lr 1e-3) in both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from jafpro_tpu.config import Config as JConfig
from jafpro_tpu.geometry.flow import SMPLFlowEngine as JEngine
from jafpro_tpu.parallel import create_mesh as jcreate_mesh, \
    data_parallel_jit as jdata_parallel_jit
from jafpro_tpu.pipeline import JAFProPipeline as JPipeline
from jafpro_tpu.train import TrainState as JTrainState
from jafpro_tpu.train import stage1 as js1, stage2 as js2, stage34 as js34

from jafpro_tpu_torch.bridge import ALL_MODULES, jax_params, load_jax_params
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.train.common import (
    TrainState, synthetic_batch, synthetic_quad_mesh, to_device)
from jafpro_tpu_torch.cli import make_step

SGD_LR = 1e-3
SIZES = dict(image_size=64, part_size=16, maximum_ref_frames=2,
             face_crop_size=16, compute_dtype="float32")
JAX_STEPS = {1: (js1.make_stage1_step, js1.stage1_lrs),
             2: (js2.make_stage2_step, js2.stage2_lrs),
             3: (js34.make_stage3_step, js34.stage3_lrs),
             4: (js34.make_stage4_step, js34.stage4_lrs)}


def numpy_params(jpipe, seed=0):
    """Numpy-seeded weights in the JAX pipeline's param-tree structure:
    kernels ~ N(0, 1/fan_in), other leaves uniform in [-0.5, 0.5)."""
    shapes = jax.eval_shape(jpipe.init_params, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[1:-1] if len(leaf.shape) == 5
                                 else leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def small_batch(seed=0):
    """A batch of 2 on the 6x6 quad mesh, 2 targets, the second sample
    with one reference masked out and its face box on half pixels."""
    verts, _ = synthetic_quad_mesh(6)
    b = synthetic_batch(np.random.RandomState(seed), batch=2, num_refs=2,
                        part_size=16, image_size=64,
                        num_verts=verts.shape[0], num_targets=2)
    b["prev_verts"] = np.tile(verts[None], (2, 1, 1))
    b["tgt_verts"] = b["prev_verts"] + np.float32([0.05, 0.0, 0.0])
    b["ref_mask"] = np.float32([[1, 1], [1, 0]])
    b["face_bbox"][1] = np.float32([20.5, 44.5, 10.5, 30.5])
    return b


def port_pipeline(params=None, **cfg_kw):
    _, faces = synthetic_quad_mesh(6)
    cfg = Config(**{**SIZES, **cfg_kw})
    pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
        faces=faces, image_size=cfg.image_size), device="cpu",
        generator=torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_params(pipe, params, ALL_MODULES)
    return pipe


def jax_pair(stage, steps=1):
    """(params before, params after, metrics) of ``steps`` SGD steps of the
    JAX package's stage ``stage`` (jitted), and the batch."""
    _, faces = synthetic_quad_mesh(6)
    jpipe = JPipeline(JConfig(**SIZES, rasterizer_face_chunk=32),
                      flow_engine=JEngine.create(faces=faces, image_size=64,
                                                 chunk=32))
    params = numpy_params(jpipe)
    make, lrs = JAX_STEPS[stage]
    txs = {k: optax.sgd(SGD_LR) for k in lrs()}
    state = JTrainState(params=params,
                        opt_states={k: txs[k].init(params[k]) for k in txs},
                        txs=txs, step=jnp.zeros((), jnp.int32))
    batch = small_batch()
    step = jax.jit(make(jpipe))
    metrics = []
    for _ in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return params, jax.tree_util.tree_map(np.asarray, state.params), \
        metrics, batch


def jax_sharded_step(stage, batch):
    """(params before, trained modules' params after, metrics) of one SGD
    step of the JAX package's ``stage`` on the global ``batch`` through its
    ``data_parallel_jit`` on 2 of the virtual CPU devices."""
    _, faces = synthetic_quad_mesh(6)
    jpipe = JPipeline(JConfig(**SIZES, rasterizer_face_chunk=32),
                      flow_engine=JEngine.create(faces=faces, image_size=64,
                                                 chunk=32))
    params = numpy_params(jpipe)
    make, lrs = JAX_STEPS[stage]
    txs = {k: optax.sgd(SGD_LR) for k in lrs()}
    state = JTrainState(
        params=params, opt_states={k: txs[k].init(params[k]) for k in txs},
        txs=txs, step=jnp.zeros((), jnp.int32))
    step = jdata_parallel_jit(make(jpipe), jcreate_mesh(2, ("data",)),
                              donate_state=False)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    after = jax.tree_util.tree_map(np.asarray, {k: state.params[k]
                                                for k in txs})
    return (jax.tree_util.tree_map(np.asarray, params), after,
            {k: float(v) for k, v in m.items()})


def port_run(stage, params, batch, steps=1):
    """The same on the port: (params after as a JAX tree, metrics)."""
    pipe = port_pipeline(params)
    step, lrs = make_step(pipe, stage)
    state = TrainState(pipe, lrs,
                       optimizer=lambda ps, lr: torch.optim.SGD(ps, SGD_LR))
    metrics = []
    for _ in range(steps):
        state, m = step(state, to_device(batch, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax_params(pipe), metrics


def real_lrs_run(stage, steps=2):
    """``steps`` steps of the port's stage with its real optimizers and
    learning rates on the port's own seeded weights: (metrics, names of
    the modules whose params moved, names of those bitwise unchanged)."""
    pipe = port_pipeline()
    before = {n: [p.detach().clone() for p in getattr(pipe, n).parameters()]
              for n in ALL_MODULES}
    step, lrs = make_step(pipe, stage)
    state = TrainState(pipe, lrs)
    metrics = []
    for i in range(steps):
        state, m = step(state, to_device(small_batch(i), "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    moved, same = set(), set()
    for n in ALL_MODULES:
        now = list(getattr(pipe, n).parameters())
        if all(torch.equal(a, b) for a, b in zip(before[n], now)):
            same.add(n)
        if any(not torch.equal(a, b) for a, b in zip(before[n], now)):
            moved.add(n)
    return metrics, moved, same, set(lrs)


def compare(stage, before, jafter, tafter, jm, tm, rtol, upd_rtol):
    """Metrics within ``rtol``; every trained param's SGD update (-lr *
    grad, read as after - before) within ``upd_rtol`` of its largest entry
    plus two float32 ulps of the param (the resolution at which an update
    can be read off the params); untrained params exactly unchanged in
    both."""
    for a, b in zip(tm, jm):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"stage {stage} metric {k}")
    trained = set(JAX_STEPS[stage][1]())
    worst = {}

    def check(path, p0, pj, pt):
        name = jax.tree_util.keystr(path)
        dj, dt = np.asarray(pj) - np.asarray(p0), np.asarray(pt) - \
            np.asarray(p0)
        module = path[0].key
        if module not in trained:
            assert not dj.any() and not dt.any(), name
            return
        scale = np.abs(dj).max()
        ulp = np.spacing(np.abs(np.asarray(p0)).max().astype(np.float32))
        err = max(np.abs(dt - dj).max() - 2 * ulp, 0.0)
        worst[name] = err / max(scale, 1e-30)
        assert err <= upd_rtol * scale, (name, err, scale)

    jax.tree_util.tree_map_with_path(check, before, jafter, tafter)
    return worst
