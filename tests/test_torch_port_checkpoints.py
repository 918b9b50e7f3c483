"""Weights trained with the JAX package reach the port: a param tree saved
with ``jafpro_tpu.checkpoints.save_checkpoint`` (orbax), exported by
``tools/export_jax_params.py`` and restored by
``jafpro_tpu_torch.checkpoints`` gives exactly the clip of the same tree
loaded through ``bridge.load_jax_params`` (S = 32, 4 parts of 16 px, 2
refs, 4 frames, float32, on the CPU)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from jafpro_tpu.checkpoints import save_checkpoint
from jafpro_tpu.config import Config as JConfig
from jafpro_tpu.pipeline import JAFProPipeline as JPipeline

from jafpro_tpu_torch.bridge import load_jax_params
from jafpro_tpu_torch.checkpoints import (
    latest_export, load_params_npz, restore_latest)
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.infer import VideoGenerator
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.utils.meshproxy import uv_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import export_jax_params  # noqa: E402

torch.set_num_threads(1)
S, PS, P, R, T = 32, 16, 4, 2, 4


def numpy_params(jpipe, seed=0):
    """Numpy-seeded weights in the JAX pipeline's param-tree structure."""
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


def small_clip(verts0, seed=0):
    rng = np.random.RandomState(seed)
    verts = (verts0[None] * np.float32([0.35, 0.9, 0.35])
             + rng.normal(scale=0.02, size=(T, 1, 3))).astype(np.float32)
    verts[..., 2] += 2.0
    iuv = np.zeros((T, S, S, 3), np.uint8)
    iuv[..., 0] = rng.randint(0, P + 1, (T, S, S))
    iuv[..., 1:] = rng.randint(0, 256, (T, S, S, 2))
    return {
        "src_parts": rng.uniform(-1, 1, (1, R, P, PS, PS, 3)),
        "src_mask_parts": (rng.rand(1, R, P, PS, PS) > 0.5) * 1.0,
        "ref_mask": np.ones((1, R)),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)),
        "src_imgs": rng.uniform(-1, 1, (R, S, S, 3)),
        "chosen_frames": np.array([0, T - 1], np.int32),
        "tgt_iuv255": iuv,
        "smpl_mask": np.ones((T, S, S, 1)),
        "cams": np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1)),
        "verts": verts,
    }


def test_export_jax_params_roundtrip(tmp_path):
    jcfg = JConfig(image_size=S, part_size=PS, num_parts=P,
                   maximum_ref_frames=R, compute_dtype="float32")
    params = numpy_params(JPipeline(jcfg, flow_engine=None))
    ckpt_dir = str(tmp_path / "checkpoints" / "exp")
    # an older step holding other weights: the newest one is exported
    save_checkpoint(ckpt_dir, 3, {"params": jax.tree_util.tree_map(
        lambda a: a + 1.0, params), "step": np.int32(3)})
    save_checkpoint(ckpt_dir, 7, {"params": params, "step": np.int32(7)})
    path = export_jax_params.export(ckpt_dir)
    assert os.path.basename(path) == "params_iter_7.npz"
    tree = load_params_npz(path)
    assert set(tree) == set(params)  # the discriminators ride along
    np.testing.assert_array_equal(
        tree["bg"]["params"]["Conv_0"]["kernel"],
        params["bg"]["params"]["Conv_0"]["kernel"])

    verts0, faces = uv_sphere(8, 10)
    cfg = Config(image_size=S, part_size=PS, num_parts=P,
                 maximum_ref_frames=R, compute_dtype="float32")

    def pipe():
        return JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
            faces=faces, image_size=S), device="cpu")

    restored, bridged = pipe(), pipe()
    assert restore_latest(restored, ckpt_dir) == 7
    load_jax_params(bridged, params)
    clip = small_clip(verts0)
    a, b = VideoGenerator(restored)(clip), VideoGenerator(bridged)(clip)
    for k in ("final", "coarse", "mask", "tsf"):
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def test_latest_export_picks_the_newest_step(tmp_path):
    assert latest_export(str(tmp_path / "none")) is None
    assert restore_latest(None, str(tmp_path / "none")) is None
    for step in (10, 9, 100):
        np.savez(tmp_path / f"params_iter_{step}.npz", x=np.zeros(1))
    np.savez(tmp_path / "params_iter_x.npz", x=np.zeros(1))
    (tmp_path / "iter_500").mkdir()
    assert latest_export(str(tmp_path)) == (
        100, str(tmp_path / "params_iter_100.npz"))
    flat = {"a/b/c": np.arange(3.0), "a/d": np.ones((2, 2)), "e": np.zeros(1)}
    np.savez(tmp_path / "tree.npz", **flat)
    tree = load_params_npz(str(tmp_path / "tree.npz"))
    np.testing.assert_array_equal(tree["a"]["b"]["c"], flat["a/b/c"])
    np.testing.assert_array_equal(tree["a"]["d"], flat["a/d"])
    assert set(tree) == {"a", "e"}


def test_restore_latest_refuses_an_unexported_newest_checkpoint(
        tmp_path, monkeypatch):
    """A directory whose newest JAX checkpoint has no export is refused
    (with the export command), whether it holds an older export or none;
    a matching export is loaded."""
    ckpt_dir = tmp_path / "exp"
    (ckpt_dir / "iter_500").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="export_jax_params.py -e exp"):
        restore_latest(None, str(ckpt_dir))
    np.savez(ckpt_dir / "params_iter_100.npz", x=np.zeros(1))
    with pytest.raises(FileNotFoundError, match="iter_500 but no "
                       "params_iter_500.npz"):
        restore_latest(None, str(ckpt_dir))
    (ckpt_dir / "iter_50").mkdir()
    (ckpt_dir / "iter_500").rmdir()
    (ckpt_dir / "iter_900").write_text("")  # a file is no checkpoint
    loaded = []
    monkeypatch.setattr("jafpro_tpu_torch.checkpoints.load_jax_params",
                        lambda pipe, tree: loaded.append(tree))
    assert restore_latest(None, str(ckpt_dir)) == 100
    assert set(loaded[0]) == {"x"}
