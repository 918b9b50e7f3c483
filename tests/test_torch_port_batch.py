"""``VideoGenerator.generate_batch`` (many clips in one pass, the JAX
package's ``vmap`` over clips) and the CLI's serving loop ``cli.serve``,
on the CPU at small widths (S = 32, 4 parts of 16 px, 2 refs, 4 frames,
a closed 160-face mesh, float32).

Tolerance: a batch of clips equals the clips generated one by one within
1e-5.
"""

import numpy as np
import pytest
import torch

from jafpro_tpu_torch import cli
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.geometry import flow as flow_mod
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.infer import VideoGenerator, stack_clips
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.utils.meshproxy import uv_sphere

torch.set_num_threads(1)
S, PS, P, R, T = 32, 16, 4, 2, 4
OUT_KEYS = ("final", "coarse", "mask", "tsf")


def make_clip(seed, faces_verts):
    verts0, _ = faces_verts
    rng = np.random.RandomState(seed)
    verts = (verts0[None] * np.float32([0.35, 0.9, 0.35])
             + rng.normal(scale=0.02, size=(T, 1, 3))).astype(np.float32)
    verts[..., 2] += 2.0
    iuv = np.zeros((T, S, S, 3), np.uint8)
    iuv[..., 0] = rng.randint(0, P + 1, (T, S, S))
    iuv[..., 1:] = rng.randint(0, 256, (T, S, S, 2))
    cams = np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1))
    cams[:, 1:] += rng.uniform(-0.05, 0.05, (T, 2)).astype(np.float32)
    return {
        "src_parts": rng.randint(0, 256, (1, R, P, PS, PS, 3)).astype(
            np.uint8),
        "src_mask_parts": (rng.rand(1, R, P, PS, PS) > 0.5).astype(
            np.uint8) * 255,
        "ref_mask": np.ones((1, R), np.float32),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32),
        "src_imgs": rng.randint(0, 256, (R, S, S, 3)).astype(np.uint8),
        "chosen_frames": np.array(sorted(rng.choice(T, R, replace=False)),
                                  np.int32),
        "tgt_iuv255": iuv,
        "smpl_mask": (rng.rand(T, S, S, 1) > 0.2).astype(np.uint8) * 255,
        "cams": cams,
        "verts": verts,
    }


@pytest.fixture(scope="module")
def small():
    mesh = uv_sphere(8, 10)
    cfg = Config(image_size=S, part_size=PS, num_parts=P,
                 maximum_ref_frames=R, compute_dtype="float32")
    pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
        faces=mesh[1], image_size=S), device="cpu")
    return {"pipe": pipe, "clips": [make_clip(s, mesh) for s in (0, 1)],
            "faces": mesh[1], "cfg": cfg}


@pytest.mark.parametrize("flow_mode,frame_batch,warp_mode", [
    ("batch", 4, "lut"), ("scan", 2, "lut"), ("batch", 1, "gather")])
def test_generate_batch_equals_per_clip(small, monkeypatch, flow_mode,
                                        frame_batch, warp_mode):
    """Two clips in one batched pass equal the two clips one by one; with
    ``flow_mode="batch"`` the rasterizer runs once on all n*T poses."""
    calls = []
    real = flow_mod.rasterize_fim_wim

    def spy(fv, *a, **k):
        calls.append(fv.shape[0])
        return real(fv, *a, **k)

    gen = VideoGenerator(small["pipe"], frame_batch=frame_batch,
                         flow_mode=flow_mode, warp_mode=warp_mode)
    singles = [gen(c) for c in small["clips"]]
    monkeypatch.setattr(flow_mod, "rasterize_fim_wim", spy)
    batch = gen.generate_batch(stack_clips(small["clips"]))
    if flow_mode == "batch":
        assert calls == [2 * T]
    else:
        assert calls == [2 * frame_batch] * (T // frame_batch)
    for k in OUT_KEYS:
        assert batch[k].shape[:2] == (2, T), k
        for i in range(2):
            np.testing.assert_allclose(batch[k][i].numpy(),
                                       singles[i][k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=(k, i))
    # the two clips really differ (per-clip indexing is exercised)
    assert np.abs(singles[0]["final"].numpy()
                  - singles[1]["final"].numpy()).max() > 1e-2


def test_stack_clips_refuses_mixed_shapes(small):
    a, b = small["clips"]
    b = dict(b, tgt_iuv255=b["tgt_iuv255"][:2])
    with pytest.raises(ValueError, match="tgt_iuv255"):
        stack_clips([a, b])
    assert set(stack_clips([a])) == set(a)


def test_serve_times_each_phase():
    wrote = []
    stats = cli.serve(list(range(5)), lambda i: i + 1,
                      lambda i, x: 2 * x, lambda i, y: wrote.append(y))
    assert sorted(wrote) == [2, 4, 6, 8, 10]
    assert stats["items"] == 5 and stats["loop_seconds"] > 0
    assert all(stats[f"{k}_ms"] >= 0 for k in ("load", "compute", "write"))
    assert cli.group_items(list("abcde"), 2) == [("a", "b"), ("c", "d"),
                                                 ("e",)]
    with pytest.raises(KeyError):
        cli.serve([1], lambda i: {}[i], lambda i, x: x, lambda i, y: None)
