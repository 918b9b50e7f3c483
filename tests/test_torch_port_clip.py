"""Port parity for the whole slice: ``jafpro_tpu_torch``'s
``JAFProPipeline`` + ``VideoGenerator`` against ``jafpro_tpu``'s on one
small clip (S = 32, 4 parts of 16 px, R = 2 refs, T = 4 frames, a closed
160-face mesh) on the CPU.

Both packages get the same numpy-seeded clip and the same numpy-seeded
weights (through ``jafpro_tpu_torch.bridge``), in float32. The JAX engine
is ``SMPLFlowEngine(faces, backend="xla", band_rows=0, depth_mode="exact")``:
the contract the Pallas kernel meets (the Pallas backend itself has no
CPU mode there). Tolerances: 1e-4 for a pipeline stage, 1e-3 for the
whole clip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.config import Config as JConfig
from jafpro_tpu.geometry.flow import SMPLFlowEngine as JEngine
from jafpro_tpu.infer import VideoGenerator as JGenerator
from jafpro_tpu.infer import frames_to_uint8 as j_frames_to_uint8
from jafpro_tpu.pipeline import JAFProPipeline as JPipeline

from jafpro_tpu_torch.bridge import load_jax_params
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.infer import VideoGenerator, frames_to_uint8
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.utils.meshproxy import uv_sphere

torch.set_num_threads(1)
S, PS, P, R, T = 32, 16, 4, 2, 4
OUT_KEYS = ("final", "coarse", "mask", "tsf")


def make_clip(seed=0):
    verts0, faces = uv_sphere(8, 10)
    rng = np.random.RandomState(seed)
    base = verts0 * np.float32([0.35, 0.9, 0.35])
    verts = (base[None] + rng.normal(scale=0.02, size=(T, 1, 3))).astype(
        np.float32)
    verts[..., 2] += 2.0
    iuv = np.zeros((T, S, S, 3), np.float32)
    iuv[..., 0] = rng.randint(0, P + 1, (T, S, S))
    iuv[..., 1:] = rng.randint(0, 256, (T, S, S, 2))
    cams = np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1))
    cams[:, 1:] += rng.uniform(-0.05, 0.05, (T, 2)).astype(np.float32)
    clip = {
        "src_parts": rng.uniform(-1, 1, (1, R, P, PS, PS, 3)),
        "src_mask_parts": (rng.rand(1, R, P, PS, PS) > 0.5),
        "ref_mask": np.ones((1, R)),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)),
        "src_imgs": rng.uniform(-1, 1, (R, S, S, 3)),
        "tgt_iuv255": iuv,
        "tgt_iuv": (iuv / 255.0 - 0.5) * 2.0,
        "smpl_mask": (rng.rand(T, S, S, 1) > 0.2),
        "cams": cams,
        "verts": verts,
    }
    clip = {k: np.asarray(v, np.float32) for k, v in clip.items()}
    clip["chosen_frames"] = np.array([0, T - 1], np.int32)
    return clip, faces


def numpy_params(jpipe, seed=0):
    """Numpy-seeded weights in the JAX pipeline's param-tree structure
    (``eval_shape`` of ``init_params``: nothing is compiled)."""
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


@pytest.fixture(scope="module")
def world():
    clip, faces = make_clip()
    jcfg = JConfig(image_size=S, part_size=PS, num_parts=P,
                   maximum_ref_frames=R, compute_dtype="float32")
    jpipe = JPipeline(jcfg, flow_engine=JEngine(
        faces=faces, image_size=S, backend="xla", band_rows=0,
        depth_mode="exact"))
    params = numpy_params(jpipe)
    cfg = Config(image_size=S, part_size=PS, num_parts=P,
                 maximum_ref_frames=R, compute_dtype="float32")
    tpipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
        faces=faces, image_size=S), device="cpu")
    load_jax_params(tpipe, params)
    return {"clip": clip, "jpipe": jpipe, "params": params, "tpipe": tpipe,
            "jout": {}}


def jax_reference(world, warp_mode):
    """The JAX generator's clip output (computed once per warp mode)."""
    if warp_mode not in world["jout"]:
        gen = JGenerator(world["jpipe"], warp_mode=warp_mode)
        out = gen(world["params"],
                  {k: jnp.asarray(v) for k, v in world["clip"].items()})
        world["jout"][warp_mode] = {k: np.asarray(out[k]) for k in OUT_KEYS}
    return world["jout"][warp_mode]


@pytest.mark.parametrize("flow_mode,frame_batch,warp_mode", [
    ("scan", 1, "lut"), ("batch", 1, "lut"), ("scan", 2, "lut"),
    ("batch", 2, "lut"), ("scan", 2, "gather"), ("batch", 4, "gather")])
def test_whole_clip_matches_jax(world, flow_mode, frame_batch, warp_mode):
    want = jax_reference(world, warp_mode)
    out = VideoGenerator(world["tpipe"], frame_batch=frame_batch,
                         flow_mode=flow_mode, warp_mode=warp_mode)(
                             world["clip"])
    for k in OUT_KEYS:
        got = out[k].numpy()
        assert got.shape == want[k].shape, k
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want[k], atol=1e-3, rtol=0,
                                   err_msg=k)
    fill = out["tsf"][0, 0, 0]
    assert not torch.all(out["tsf"] == fill)  # the flow branch saw the mesh


def test_output_uint8_and_frames_to_uint8(world):
    want = jax_reference(world, "lut")
    out = VideoGenerator(world["tpipe"], output_uint8=True)(world["clip"])
    for k in OUT_KEYS:
        assert out[k].dtype == torch.uint8
        if k != "mask":
            enc = j_frames_to_uint8(want[k]).astype(int)
            # 1e-3 apart in (-1, 1) can straddle one rounding step
            assert np.abs(out[k].numpy().astype(int) - enc).max() <= 1, k
    x = np.random.RandomState(3).uniform(-1.2, 1.2, (2, 4, 4, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(frames_to_uint8(torch.from_numpy(x)),
                                  j_frames_to_uint8(x))
    assert frames_to_uint8(out["final"]) is not None


def test_uint8_wire_clip(world):
    """A uint8 wire-format clip decodes on the device to the float clip."""
    clip = dict(world["clip"])
    u8 = {
        "src_imgs": np.round((clip["src_imgs"] + 1) / 2 * 255).astype(np.uint8),
        "smpl_mask": (clip["smpl_mask"] * 255).astype(np.uint8),
        "tgt_iuv255": clip["tgt_iuv255"].astype(np.uint8),
    }
    f32 = dict(clip, src_imgs=u8["src_imgs"] / 255.0 * 2.0 - 1.0,
               smpl_mask=u8["smpl_mask"] / 255.0)
    f32 = {k: np.asarray(v, np.float32) if k != "chosen_frames" else v
           for k, v in f32.items()}
    wire = dict(clip, **u8)
    del wire["tgt_iuv"]
    gen = VideoGenerator(world["tpipe"])
    a, b = gen(wire), gen(f32)
    for k in OUT_KEYS:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5,
                                   rtol=0)


def test_pipeline_stages_match_jax(world):
    jpipe, params, tpipe = world["jpipe"], world["params"], world["tpipe"]
    clip = world["clip"]
    j = {k: jnp.asarray(v) for k, v in clip.items()}
    t = {k: torch.from_numpy(v) for k, v in clip.items()}

    jinp, junion = jax.jit(jpipe.prepare_textures)(
        params, j["src_parts"], j["ref_mask"], j["src_mask_parts"])
    with torch.no_grad():
        tinp, tunion = tpipe.prepare_textures(
            t["src_parts"], t["ref_mask"], t["src_mask_parts"])
        np.testing.assert_allclose(tinp.numpy(), np.asarray(jinp), atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(tunion.numpy(), np.asarray(junion))

        jbg = jax.jit(jpipe.background)(params, j["bg_incomplete"])
        tbg = tpipe.background(t["bg_incomplete"])
        np.testing.assert_allclose(tbg.numpy(), np.asarray(jbg), atol=1e-4,
                                   rtol=0)

        i, src = np.array([1, 2]), np.array([0, 1])
        jargs = (jinp, jbg, j["tgt_iuv255"][i], j["tgt_iuv"][i],
                 j["smpl_mask"][i], j["src_imgs"][src], j["cams"][src],
                 j["verts"][src], j["cams"][i], j["verts"][i])
        targs = (tinp, tbg, t["tgt_iuv255"][i], t["tgt_iuv"][i],
                 t["smpl_mask"][i], t["src_imgs"][src], t["cams"][src],
                 t["verts"][src], t["cams"][i], t["verts"][i])
        want = jax.jit(jpipe.generate_frame)(params, *jargs)
        got = tpipe.generate_frame(*targs)
    for k in ("final", "weight", "fusion", "refined", "fg_mask", "tsf",
              "warped"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=0, err_msg=k)


def test_bridge_is_strict(world):
    params = dict(world["params"])
    params["pro"] = {"params": dict(params["pro"]["params"])}
    params["pro"]["params"].pop("CompositeWeightUnet_0")
    with pytest.raises(RuntimeError):
        load_jax_params(world["tpipe"], params)


def test_generator_rejects_unknown_modes(world):
    for kw in ({"flow_mode": "band"}, {"warp_mode": "mm8"},
               {"frame_batch": 0}):
        with pytest.raises(ValueError):
            VideoGenerator(world["tpipe"], **kw)


@pytest.mark.parametrize("flow_mode", ["scan", "batch"])
def test_stage_clock_times_every_stage(world, flow_mode):
    """The stage clock leaves the output as it is and times each stage."""
    gen = VideoGenerator(world["tpipe"], frame_batch=2, flow_mode=flow_mode)
    plain = gen(world["clip"])
    assert gen.stage_ms == {}
    gen.time_stages = True
    timed = gen(world["clip"])
    for k in OUT_KEYS:
        np.testing.assert_array_equal(timed[k].numpy(), plain[k].numpy())
    assert set(gen.stage_ms) == {
        "accumulate+inpaint", "background CRN", "texture warp",
        "refine CRN+fuse", "flow branch", "propagation"}
    assert all(v >= 0.0 for v in gen.stage_ms.values())
