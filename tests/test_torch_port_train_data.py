"""Port parity for the training input and optimizer machinery:
``jafpro_tpu_torch`` against ``jafpro_tpu`` on the CPU.

The curriculum, synthetic batches, record specs, the shard reader and the
dataset loaders must give exactly the JAX package's arrays for the same
seed. The optimizer (Adam at optax's defaults and the MultiStepLR
schedule) is held to optax on fixed gradients: learning rates within rtol
1e-6, params within atol 1e-6 (1e-4 of the learning rate: torch and optax
round the bias corrections in another order, a few float32 ulps over
eight updates).
"""

import os
import sys

import numpy as np
import optax
import pytest
import torch
from torch import nn

from jafpro_tpu.data import dataset as jds
from jafpro_tpu.data import shardio as jsio
from jafpro_tpu.train import common as jcommon

from jafpro_tpu_torch.data import dataset as tds
from jafpro_tpu_torch.data import shardio as tsio
from jafpro_tpu_torch.train import common as tcommon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_fixture import write_fixture  # noqa: E402

torch.set_num_threads(1)


def assert_same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


# ------------------------------------------------------------ curriculum

def test_synthetic_batch_and_mesh_same_for_seed():
    kw = dict(batch=2, num_refs=2, part_size=8, image_size=16, num_verts=36)
    assert_same_batch(
        tcommon.synthetic_batch(np.random.RandomState(5), **kw),
        jcommon.synthetic_batch(np.random.RandomState(5), **kw))
    for a, b in zip(tcommon.synthetic_quad_mesh(6),
                    jcommon.synthetic_quad_mesh(6)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_curriculum_same_for_seed(stage):
    """The same raw batch through both curricula from the same seed, for
    several draws: the same reference masks, propagation sources and
    dropped fields."""
    rng = np.random.RandomState(0)
    B, R, S, V = 3, 4, 8, 5
    raw = {
        "src_parts": rng.rand(B, R, 24, 2, 2, 3).astype(np.float32),
        "src_imgs": rng.rand(B, R, S, S, 3).astype(np.float32),
        "src_cams": rng.rand(B, R, 3).astype(np.float32),
        "src_verts": rng.rand(B, R, V, 3).astype(np.float32),
        "src_frame_indices": rng.randint(0, 9, (B, R)).astype(np.int32),
    }
    trng, jrng = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(4):
        got = tcommon.apply_curriculum(dict(raw), stage, trng, R)
        want = jcommon.apply_curriculum(dict(raw), stage, jrng, R)
        assert_same_batch(got, want)
    for _ in range(20):
        np.testing.assert_array_equal(
            tcommon.sample_reference_curriculum(trng, 4)[0],
            jcommon.sample_reference_curriculum(jrng, 4)[0])


# ------------------------------------------------------------- optimizer

class _Holder(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.m = nn.Module()
        self.m.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.m.b = nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("lr", ["float", "multistep"])
def test_adam_and_multistep_lr_match_optax(lr):
    """Eight updates on fixed gradients: the learning rate of each update
    and the params after it equal optax.adam's (the schedule counts the
    updates of its own optimizer)."""
    rng = np.random.RandomState(1)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(
        np.float32)
    grads = [(rng.randn(3, 4).astype(np.float32) * 10 ** rng.uniform(-6, 1),
              rng.randn(5).astype(np.float32)) for _ in range(8)]
    if lr == "float":
        tlr, jlr = 1e-2, 1e-2
    else:
        tlr = tcommon.multistep_lr(1e-2, milestones=(2, 5), gamma=0.3)
        jlr = jcommon.multistep_lr(1e-2, milestones=(2, 5), gamma=0.3)
        np.testing.assert_allclose(
            [tlr(c) for c in range(8)], [float(jlr(c)) for c in range(8)],
            rtol=1e-7)
    holder = _Holder(a, b)
    state = tcommon.TrainState(holder, {"m": tlr})
    tx = optax.adam(jlr)
    params = (a, b)
    opt_state = tx.init(params)
    for it, g in enumerate(grads):
        if lr == "multistep":
            np.testing.assert_allclose(
                state.opts["m"].param_groups[0]["lr"], float(jlr(it)),
                rtol=1e-6)
        state.apply_gradients({"m": [torch.from_numpy(x) for x in g]})
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, q in zip(state.params["m"], params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       rtol=0, atol=1e-6)
    assert state.step == len(grads)


def test_train_state_grads_zero_for_unreached_and_round_trip():
    holder = _Holder(np.ones((2, 2), np.float32), np.ones(3, np.float32))
    state = tcommon.TrainState(holder, {"m": 0.1})
    loss = (holder.m.a ** 2).sum()
    g = state.grads(loss, ("m",))["m"]
    np.testing.assert_array_equal(g[0].numpy(), 2 * np.ones((2, 2)))
    np.testing.assert_array_equal(g[1].numpy(), np.zeros(3))
    state.apply_gradients({"m": g})
    sd = state.state_dict()
    other = tcommon.TrainState(_Holder(np.ones((2, 2), np.float32),
                                       np.ones(3, np.float32)), {"m": 0.1})
    other.load_state_dict(sd)
    assert other.step == 1
    with pytest.raises(ValueError, match="optimizer states"):
        tcommon.TrainState(holder, {}).load_state_dict(sd)


# ----------------------------------------------------------------- specs

@pytest.mark.parametrize("stage", [1, 2, 3, 4])
@pytest.mark.parametrize("sizes", [{}, dict(num_refs=2, image_size=64,
                                            part_size=16, num_verts=36)])
def test_specs_equal_jax(stage, sizes):
    got = tsio.stage_spec(stage, **sizes)
    want = jsio.stage_spec(stage, **sizes)
    assert [(n, tuple(s), d) for n, s, d in got] == \
        [(n, tuple(s), d) for n, s, d in want]
    assert tsio.spec_hash(got) == jsio.spec_hash(want)
    assert tsio._SINGLE_TARGET_FIELDS == jsio._SINGLE_TARGET_FIELDS
    rng = np.random.RandomState(stage)
    batch = {n: rng.randint(0, 255, (2,) + tuple(s)).astype(d)
             for n, s, d in want}
    assert_same_batch(tsio.collapse_target_dims(got, batch),
                      jsio.collapse_target_dims(want, batch))


def test_shard_reader_same_batches_as_jax(tmp_path):
    """Two shards packed by the JAX package, read by both readers with
    shuffle on and the same seed, across three epochs: the same batches
    in the same order (one worker thread, which fixes the order)."""
    spec = jsio.interval_spec(num_refs=2, image_size=8, part_size=4,
                              num_verts=5)
    rng = np.random.RandomState(0)

    def record():
        return {n: (rng.randint(0, 255, s).astype(d) if d == "uint8"
                    else rng.randn(*s).astype(d)) for n, s, d in spec}

    paths = [str(tmp_path / "a.shard"), str(tmp_path / "b.shard")]
    jsio.pack_shard(spec, [record() for _ in range(5)], paths[0])
    jsio.pack_shard(spec, [record() for _ in range(4)], paths[1])
    kw = dict(batch=2, prefetch=2, threads=1, seed=7, shuffle=True,
              loop=True)
    with tsio.ShardReader(spec, paths, **kw) as got:
        want = jsio.ShardReader(spec, paths, **kw)
        try:
            assert got.num_records == want.num_records == 9
            firsts = set()
            for _ in range(14):
                g, w = next(got), next(want)
                assert_same_batch(g, w)
                firsts.add(g["src_parts"].tobytes()[:64])
            assert len(firsts) > 4   # shuffled over all records
        finally:
            want.close()
    # loop=False stops after the last whole batch of the epoch
    with tsio.ShardReader(spec, paths, batch=4, threads=2, seed=7,
                          loop=False) as r:
        assert sum(1 for _ in r) == 2
    with pytest.raises(IOError, match="spec hash"):
        tsio.ShardReader(jsio.interval_spec(num_refs=3, image_size=8,
                                            part_size=4, num_verts=5), paths)


# --------------------------------------------------------------- loaders

@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fx"))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("JAFPRO_SMPL_FACES", raising=False)
        write_fixture(root, vids_per_mode=2, frames=7, image_size=64, seed=0)
    return root


def test_face_bbox_and_frame_sampling():
    iuv = np.zeros((32, 32, 3), np.float32)
    assert np.array_equal(tds.face_bbox_from_iuv(iuv, 32),
                          jds.face_bbox_from_iuv(iuv, 32))
    iuv[3:9, 28:31, 0] = 23
    iuv[10, 2, 0] = 24
    np.testing.assert_array_equal(tds.face_bbox_from_iuv(iuv, 32),
                                  jds.face_bbox_from_iuv(iuv, 32))
    for fix, recon in ((True, False), (False, False), (False, True)):
        trng, jrng = np.random.RandomState(3), np.random.RandomState(3)
        for _ in range(12):
            np.testing.assert_array_equal(
                tds.sample_frame_indices(9, trng, 4, 3, fix, recon),
                jds.sample_frame_indices(9, jrng, 4, 3, fix, recon))


def test_loaders_on_fixture(fixture_root):
    data = os.path.join(fixture_root, "data", "train")
    smpl = os.path.join(fixture_root, "smpl", "train")
    mask = os.path.join(fixture_root, "mask", "train")
    vid = tds.list_videos(os.path.join(fixture_root, "data"), "train")[0]
    trng, jrng = np.random.RandomState(1), np.random.RandomState(1)
    assert_same_batch(
        tds.load_textonly_sample(data, vid, trng, 2, 2, fix_frame=False),
        jds.load_textonly_sample(data, vid, jrng, 2, 2, fix_frame=False))
    got = tds.load_interval_sample(data, smpl, mask, vid, trng, 2, 1)
    want = jds.load_interval_sample(data, smpl, mask, vid, jrng, 2, 1)
    assert_same_batch(got, want)
    assert got["src_parts"].shape == (1, 2, 24, 200, 200, 3)
    # the same draws leave both generators in the same state
    assert trng.randint(1 << 30) == jrng.randint(1 << 30)
