"""Data parallelism in the port (``jafpro_tpu_torch/parallel``) on 2 gloo
ranks on the CPU, mirroring ``tests/test_parallel.py``.

One set of ranks runs every check (``_torch_parallel_helpers.rank_units``);
each test reads its part. Held to:
  * the mesh helpers: ``create_mesh``'s view, ``shard_batch``'s slices and
    refusals, ``replicate`` (bitwise);
  * the linear model's synchronised step against
    ``jafpro_tpu.parallel.data_parallel_jit`` on 2 of the 8 virtual CPU
    devices, same inputs from a numpy seed: atol 1e-6;
  * ``BatchStatsNorm(per_sample=False)`` over the ranks against the layer
    on the whole batch: forward within 1e-6, input and parameter
    gradients within 1e-5 relative L2;
  * ``bce_masked`` with 2 faces on rank 0 and none on rank 1 against the
    global value and its gradients (1e-6), which a per-rank mean misses;
  * ``VideoGenerator.generate_batch(clips, mesh)`` against each clip alone
    within 2e-5, and the same whole result on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_helpers as H
from jafpro_tpu.parallel import create_mesh as jcreate_mesh
from jafpro_tpu.parallel import data_parallel_jit as jdata_parallel_jit

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    inputs = {
        "linear": (rng.randn(16, 4).astype(np.float32),
                   rng.randn(16, 1).astype(np.float32)),
        "norm": H.batch_stats_norm_case(),
        "bce": H.bce_case(),
        "clips": [H.gen_clip(s) for s in range(4)],
    }
    ranks = H.run_ranks(H.rank_units, inputs,
                        tmp=tmp_path_factory.mktemp("ranks"))
    return inputs, ranks


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def test_create_mesh_and_shard_batch(runs):
    _, ranks = runs
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, out in enumerate(r["basics"] for r in ranks):
        assert (out["world"], out["rank"], out["device"], out["backend"]) \
            == (2, r, "cpu", "gloo")
        np.testing.assert_array_equal(out["x"], x[4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["z"], np.arange(4 * r, 4 * r + 4))
        assert out["passthrough"]
        no_div, axes, size, shape = out["refusals"]
        assert no_div == "batch_size 3 not divisible by --num-devices 2"
        assert "1-D" in axes and "('data', 'model')" in axes
        assert "has 2 ranks" in size
        assert "1-D" in shape


def test_replicate(runs):
    _, ranks = runs
    a, b = (r["basics"]["net"] for r in ranks)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # rank 1 started elsewhere: replicate really moved its weights
    torch.manual_seed(101)
    other = torch.nn.Linear(3, 4).weight.detach().numpy()
    assert not np.array_equal(other, b["0.weight"])


def test_data_parallel_jit_grad_sync_matches_jax(runs):
    """The linear model's sharded SGD step equals the JAX package's
    ``data_parallel_jit`` step on 2 virtual devices (and its own global
    update): the gradient is the global batch's."""
    inputs, ranks = runs
    x, y = inputs["linear"]

    def step(state, batch):
        def loss(w):
            return jnp.mean((batch["x"] @ w - batch["y"]) ** 2)

        g = jax.grad(loss)(state["w"])
        return {"w": state["w"] - 0.1 * g}, jnp.mean(batch["x"])

    mesh = jcreate_mesh(2, ("data",))
    fn = jdata_parallel_jit(step, mesh, donate_state=False)
    jstate, jaux = fn({"w": jnp.zeros((4, 1))}, {"x": x, "y": y})
    for r in ranks:
        np.testing.assert_allclose(r["linear"]["w"], np.asarray(jstate["w"]),
                                   atol=1e-6)
        np.testing.assert_allclose(r["linear"]["aux"], float(jaux),
                                   atol=1e-6)
    assert ranks[0]["linear"]["aux"] == ranks[1]["linear"]["aux"]


def test_batch_stats_norm_takes_global_statistics(runs):
    inputs, ranks = runs
    full = H.batch_stats_norm_step(inputs["norm"])
    y = np.concatenate([r["norm"]["y"] for r in ranks])
    np.testing.assert_allclose(y, full["y"], atol=1e-6)
    gx = np.concatenate([r["norm"]["gx"] for r in ranks])
    assert rel_l2(gx, full["gx"]) <= 1e-5
    for r in ranks:
        for k in ("gs", "gb"):
            assert rel_l2(r["norm"][k], full[k]) <= 1e-5, k
    # the shard's own statistics would be another layer
    alone = H.batch_stats_norm_step({**inputs["norm"], "x": inputs["norm"][
        "x"][:2], "w": inputs["norm"]["w"][:2]})
    assert np.abs(alone["y"] - ranks[0]["norm"]["y"]).max() > 1e-2


def test_bce_masked_divides_by_the_global_count(runs):
    """2 valid samples on rank 0, none on rank 1: the mean over the ranks
    of the ranks' values is the global value, the gradients the global
    gradients; the mean of per-rank means is half of it."""
    inputs, ranks = runs
    full = H.bce_step(inputs["bce"])
    for r in ranks:
        g = r["bce"]["global"]
        np.testing.assert_allclose(g["val"], full["val"], rtol=1e-6)
        np.testing.assert_allclose(g["gw"], full["gw"], rtol=1e-6,
                                   atol=1e-7)
    gf = np.concatenate([r["bce"]["global"]["gf"] for r in ranks])
    np.testing.assert_allclose(gf, full["gf"], rtol=1e-6, atol=1e-7)
    assert not np.any(gf[2:])
    wrong = ranks[0]["bce"]["per_rank_mean"]
    np.testing.assert_allclose(wrong["val"], full["val"] / 2, rtol=1e-6)
    assert not np.allclose(wrong["gw"], full["gw"], rtol=1e-3)


def test_generate_batch_over_ranks(runs):
    """Each rank generates its 2 of 4 clips; every rank gets the whole
    (4, T, S, S, C) result, and each clip equals the clip alone
    (``tests/test_train.py::test_video_generator_batch_sharded``)."""
    _, ranks = runs
    for r in ranks:
        assert r["generate"]["shape"] == (4, H.GEN_T, 32, 32, 3)
        assert r["generate"]["diff"] <= 2e-5
    assert ranks[0]["generate"]["digest"] == ranks[1]["generate"]["digest"]
