"""The flow harness's data and state in the port: ``data/flow_datasets.py``
against ``jafpro_tpu.data.flow_datasets`` on ``tmp_path`` fixtures laid
out as ``tests/test_flow_harness.py`` builds them (indexes equal, batches
from the same ``RandomState`` equal), the harness's ``jax.image.resize``
equivalent and ``synthetic_flow_batch`` against the JAX package's, and
``save_flow_state`` / ``restore_flow_state`` round trips.

Tolerances: indexes and file batches equal; the linear resize within
1e-6 of ``jax.image.resize`` (float32 sums in another order); the
synthetic batch within 1e-5; a restored state equal to the saved one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.data import flow_datasets as jfd
from jafpro_tpu.train import flow_harness as jh

from jafpro_tpu_torch.bridge import flax_from_state_dict
from jafpro_tpu_torch.checkpoints import flatten, load_params_npz
from jafpro_tpu_torch.data import flow_datasets as tfd
from jafpro_tpu_torch.train import flow_harness as th

torch.set_num_threads(1)


def _write_img(path, rng, h=96, w=128):
    import cv2

    cv2.imwrite(str(path), (rng.rand(h, w, 3) * 255).astype(np.uint8))


def same_batch(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


def test_flo_round_trip_both_ways(tmp_path):
    flow = np.random.RandomState(0).randn(9, 13, 2).astype(np.float32)
    tfd.write_flo(str(tmp_path / "t.flo"), flow)
    jfd.write_flo(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tfd.read_flo(str(tmp_path / "j.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        tfd.read_flo(str(tmp_path / "bad.flo"))
    with pytest.raises(ValueError, match="H, W, 2"):
        tfd.write_flo(str(tmp_path / "x.flo"), flow[..., :1])


def test_flying_chairs_source_same_batches(tmp_path):
    rng = np.random.RandomState(1)
    for i in range(3):
        _write_img(tmp_path / f"{i:05d}_img1.ppm", rng)
        _write_img(tmp_path / f"{i:05d}_img2.ppm", rng)
        tfd.write_flo(str(tmp_path / f"{i:05d}_flow.flo"),
                      rng.randn(96, 128, 2).astype(np.float32))
    assert tfd.index_flying_chairs(str(tmp_path)) == \
        jfd.index_flying_chairs(str(tmp_path))
    for random_crop in (True, False):
        t = tfd.make_source("FlyingChairs", str(tmp_path), (64, 80),
                            random_crop)
        j = jfd.make_source("FlyingChairs", str(tmp_path), (64, 80),
                            random_crop)
        tr, jr = np.random.RandomState(7), np.random.RandomState(7)
        for _ in range(2):
            same_batch(t.sample_batch(tr, 2), j.sample_batch(jr, 2))
    xs, ys = t.sample_batch(np.random.RandomState(0), 2)
    assert xs.shape == (2, 64, 80, 6) and ys.shape == (2, 64, 80, 2)
    (tmp_path / "extra.ppm").write_bytes(b"")
    with pytest.raises(ValueError, match="2 images per flow"):
        tfd.index_flying_chairs(str(tmp_path))
    with pytest.raises(KeyError, match="unknown flow dataset"):
        tfd.make_source("KITTI", str(tmp_path), (8, 8))


def test_sintel_and_folder_indexes(tmp_path):
    rng = np.random.RandomState(2)
    for scene in ("alley_1", "test_x"):
        (tmp_path / "flow" / scene).mkdir(parents=True)
        (tmp_path / "final" / scene).mkdir(parents=True)
        for n in (1, 2, 3):
            tfd.write_flo(str(tmp_path / "flow" / scene / f"frame_{n:04d}.flo"),
                          rng.randn(8, 8, 2).astype(np.float32))
            _write_img(tmp_path / "final" / scene / f"frame_{n:04d}.png",
                       rng, 8, 8)
    got = tfd.index_mpi_sintel(str(tmp_path), "final")
    assert got == jfd.index_mpi_sintel(str(tmp_path), "final")
    assert len(got[0]) == 2      # frame 3 has no successor; test_* skipped
    folder = tmp_path / "final" / "alley_1"
    assert tfd.index_images_from_folder(str(folder)) == \
        jfd.index_images_from_folder(str(folder))


def test_chairs_sdhom_flipped_like_jax(tmp_path):
    rng = np.random.RandomState(3)
    for sub in ("t0", "t1", "flow"):
        (tmp_path / "test" / sub).mkdir(parents=True)
    for i in range(2):
        _write_img(tmp_path / "test" / "t0" / f"{i}.png", rng, 16, 20)
        _write_img(tmp_path / "test" / "t1" / f"{i}.png", rng, 16, 20)
        tfd.write_flo(str(tmp_path / "test" / "flow" / f"{i}.flo"),
                      rng.randn(16, 20, 2).astype(np.float32))
    t = tfd.make_source("ChairsSDHomTest", str(tmp_path), (12, 16))
    j = jfd.make_source("ChairsSDHomTest", str(tmp_path), (12, 16))
    assert t.flip_flow_vertical and j.flip_flow_vertical
    same_batch(t.sample_batch(np.random.RandomState(4), 3),
               j.sample_batch(np.random.RandomState(4), 3))


@pytest.mark.parametrize("shape,size", [((2, 4, 4, 2), (64, 64)),
                                        ((1, 5, 7, 3), (13, 9)),
                                        ((1, 64, 48, 2), (24, 20))])
def test_linear_resize_matches_jax_image_resize(shape, size):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(
        jnp.asarray(x), (shape[0], *size, shape[3]), "linear"))
    got = th.resize_linear_nhwc(x, size)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_synthetic_flow_batch_matches_jax():
    got = th.synthetic_flow_batch(np.random.RandomState(6), 2, 64)
    want = jh.synthetic_flow_batch(np.random.RandomState(6), 2, 64)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_save_and_restore_flow_state(tmp_path):
    """A state saved after two steps restores into a fresh one (params,
    ``batch_stats``, Adam moments and count, step) and the next step of
    both is equal; the file holds flax-layout trees."""
    pairs, flow = th.synthetic_flow_batch(np.random.RandomState(7), 1, 64)
    init_fn, step_fn = th.make_flow_train_step("sd", lr=3e-4, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    blank, start = th.restore_flow_state(str(tmp_path / "ck"),
                                         init_fn(torch.Generator()))
    assert start == 0 and blank.step == 0
    for _ in range(2):
        state, _ = step_fn(state, pairs, flow)
    path = th.save_flow_state(str(tmp_path / "ck"), 2, state)
    th.save_flow_state(str(tmp_path / "ck"), 1, state)
    tree = load_params_npz(path)
    assert set(tree) == {"params", "batch_stats", "opt"}
    assert int(tree["opt"]["count"]) == 2
    assert tree["params"]["conv0"]["Conv_0"]["kernel"].shape == (3, 3, 6, 64)
    assert tree["opt"]["mu"]["conv0"]["Conv_0"]["kernel"].shape == (
        3, 3, 6, 64)

    fresh, start = th.restore_flow_state(
        str(tmp_path / "ck"), init_fn(torch.Generator().manual_seed(1)))
    assert start == 2 and fresh.step == 2
    a, b = flatten(flax_from_state_dict(state.model)), flatten(
        flax_from_state_dict(fresh.model))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        sp, sq = state.opt.state[p], fresh.opt.state[q]
        assert float(sp["step"]) == float(sq["step"]) == 2
        torch.testing.assert_close(sq["exp_avg"], sp["exp_avg"], rtol=0,
                                   atol=0)
        torch.testing.assert_close(sq["exp_avg_sq"], sp["exp_avg_sq"],
                                   rtol=0, atol=0)
    _, m1 = step_fn(state, pairs, flow)
    _, m2 = step_fn(fresh, pairs, flow)
    assert float(m1["loss"]) == float(m2["loss"])
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0)
