"""The port's host leftovers and the zoo's entry points, against
``jafpro_tpu`` on the CPU: ``data/texture.py``'s ``atlas_to_parts``
(exact), ``texture_warp`` (1e-5), ``unwrap_texture``,
``iuv_to_part_masks`` and ``texture_fusion`` (exact: the same NumPy and
``cv2``); ``geometry/flow.py``'s ``swap_smpl`` (exact);
``utils/visualizer.py`` (the same files); ``utils/profiling.py``; the
public names of this slice's modules (``tools/port_names.py``); and the
zoo's constructors, which raise without CUDA unless asked for the CPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.data import texture as jtex
from jafpro_tpu.geometry import flow as jflow
from jafpro_tpu.utils import visualizer as jvis

from jafpro_tpu_torch.data import texture as ttex
from jafpro_tpu_torch.geometry import flow as tflow
from jafpro_tpu_torch.utils import profiling as tprof
from jafpro_tpu_torch.utils import visualizer as tvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.RandomState(0)


def iuv_map(seed, S=48):
    rng = np.random.RandomState(seed)
    iuv = rng.randint(0, 256, (S, S, 3)).astype(np.uint8)
    iuv[..., 0] = rng.randint(0, 25, (S, S))
    iuv[:4, :4, 0] = 0
    return iuv


def test_atlas_to_parts_and_texture_warp():
    p = 8
    atlas = RNG.uniform(-1, 1, (2, 4 * p, 6 * p, 3)).astype(np.float32)
    parts = ttex.atlas_to_parts(torch.from_numpy(atlas), p)
    want = np.asarray(jtex.atlas_to_parts(jnp.asarray(atlas), p))
    np.testing.assert_array_equal(parts.numpy(), want)
    np.testing.assert_array_equal(ttex.parts_to_atlas(parts).numpy(), atlas)

    iuv = np.stack([iuv_map(1), iuv_map(2)]).astype(np.float32)
    got = ttex.texture_warp(parts, torch.from_numpy(iuv))
    want = np.asarray(jtex.texture_warp(jnp.asarray(want), jnp.asarray(iuv)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tex_size,part_size", [(32, 200), (16, 24)])
def test_unwrap_texture_and_part_masks(tex_size, part_size):
    image = RNG.randint(0, 256, (48, 48, 3)).astype(np.uint8)
    iuv = iuv_map(3)
    iuv[iuv[..., 0] == 7, 0] = 8   # a part no pixel sees stays 0
    got = ttex.unwrap_texture(image, iuv, tex_size, part_size)
    want = jtex.unwrap_texture(image, iuv, tex_size, part_size)
    np.testing.assert_array_equal(got, want)
    assert not got[6].any() and got.dtype == np.float32
    np.testing.assert_array_equal(
        ttex.iuv_to_part_masks(iuv, tex_size, part_size),
        jtex.iuv_to_part_masks(iuv, tex_size, part_size))


def test_texture_fusion():
    t1 = RNG.randint(0, 256, (40, 40, 3)).astype(np.uint8)
    t2 = RNG.randint(0, 256, (40, 40, 3)).astype(np.uint8)
    m1 = (RNG.rand(40, 40) > 0.5).astype(np.uint8) * 255
    m2 = (RNG.rand(40, 40) > 0.4).astype(np.uint8) * 255
    for radius in (3, 7):
        for a, b in zip(ttex.texture_fusion(t1, t2, m1, m2, radius),
                        jtex.texture_fusion(t1, t2, m1, m2, radius)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["smooth", "source", "target"])
def test_swap_smpl(strategy):
    src_cam = RNG.rand(3, 3).astype(np.float32)
    src_shape = RNG.rand(3, 10).astype(np.float32)
    tgt = RNG.rand(3, 85).astype(np.float32)
    first = RNG.rand(3, 3).astype(np.float32)
    got = tflow.swap_smpl(*map(torch.from_numpy, (src_cam, src_shape, tgt,
                                                  first)), strategy)
    want = jflow.swap_smpl(*map(jnp.asarray, (src_cam, src_shape, tgt,
                                              first)), strategy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_visualizer_writes_what_jax_writes(tmp_path):
    imgs = RNG.uniform(-1, 1, (3, 3, 16, 16)).astype(np.float32)
    kp = RNG.uniform(-1, 1, (2, 19, 2)).astype(np.float32)
    for mod, name in ((jvis, "jax"), (tvis, "port")):
        viz = mod.DashboardVisualizer("exp", out_dir=str(tmp_path / name),
                                      time_step=2)
        viz.vis_named_img("samples", torch.from_numpy(imgs))
        viz.vis_preds_gts(preds=imgs[:, :1], gts=imgs[:, :1])
        viz.vis_keypoints(kp, kp[:, :14])
        viz.vis_named_img("nhwc", np.transpose(imgs, (0, 2, 3, 1)),
                          transpose=True)
    jdir, tdir = tmp_path / "jax" / "exp", tmp_path / "port" / "exp"
    files = sorted(f for f in os.listdir(jdir) if f != "index.html")
    assert sorted(f for f in os.listdir(tdir) if f != "index.html") == files
    assert len(files) == 8
    for f in files:
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    assert tvis.skeleton_svg(kp[0], "t", plus=True) == jvis.skeleton_svg(
        kp[0], "t", plus=True)


def test_video_makers(tmp_path):
    import cv2

    paths = []
    for i in range(4):
        p = str(tmp_path / f"f{i}.png")
        cv2.imwrite(p, RNG.randint(0, 255, (32, 32, 3)).astype(np.uint8))
        paths.append(p)
    np.testing.assert_array_equal(tvis.fuse_image(paths, 2, 2),
                                  jvis.fuse_image(paths, 2, 2))
    out = tvis.make_video(str(tmp_path / "vid.mp4"), paths, fps=4)
    assert os.path.getsize(out) > 0
    out = tvis.fuse_video([paths, paths], str(tmp_path / "fused.mp4"), 1,
                          2, fps=4)
    assert os.path.getsize(out) > 0


def test_profiling(tmp_path):
    with tprof.step_timer() as t:
        torch.ones(64, 64).sum()
    assert t["seconds"] > 0
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    traces = os.listdir(tmp_path / "trace")
    assert traces and all(f.endswith(".json") for f in traces)


# the JAX package's public names that the port of this slice's modules
# leaves out on purpose (ROADMAP.md, "Left out on purpose")
LEFT_OUT = {"data/texture": {"texture_warp_mm"}, "utils/__init__": {"Logger"}}
SLICE = ("models/ablations", "models/accumulate", "models/common",
         "models/conv_lstm", "models/crn", "models/__init__",
         "data/texture", "data/__init__", "geometry/flow",
         "utils/visualizer", "utils/profiling", "utils/__init__")


def test_public_names_of_the_slice():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import port_names
    finally:
        sys.path.pop(0)
    for module in SLICE:
        names, lack = port_names.missing(module)
        assert names, module
        assert set(lack) == LEFT_OUT.get(module, set()), (module, lack)
    out = subprocess.run([sys.executable, "tools/port_names.py", *SLICE],
                         cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    assert out.count("\n") == len(SLICE)


def test_zoo_entry_points_refuse_missing_cuda(monkeypatch):
    """Without CUDA, each zoo network and recurrence built without a
    ``device`` raises instead of running on the CPU."""
    from jafpro_tpu_torch.models import ablations as ta
    from jafpro_tpu_torch.models.accumulate import AccumulateGRU
    from jafpro_tpu_torch.models.conv_lstm import ConvGRU, ConvLSTM
    from jafpro_tpu_torch.models.crn import CRN, CRNSmall

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: ConvLSTM(3, 4), lambda: ConvGRU(3, 4), lambda: CRN(),
        lambda: CRNSmall(), lambda: AccumulateGRU(2),
        lambda: ta.UNetSE(), lambda: ta.UNetGenerator(), lambda: ta.UNetTA(),
        lambda: ta.AccumulatePlain(2), lambda: ta.AccumulateMaxFusion(2),
        lambda: ta.AccumulateAvgFusion(2), lambda: ta.AccumulateMask(2),
        lambda: ta.CodeEncoder(), lambda: ta.CodeDecoder(),
        lambda: ta.MaxFusionModule(2), lambda: ta.Vid2VidResnetBlock(8),
        lambda: ta.PredictiveModule(n_blocks=1), lambda: ta.BlendingModule(),
        lambda: ta.EdgeConnectResnetBlock(8),
        lambda: ta.InpaintGenerator(residual_blocks=1),
        lambda: ta.EdgeGenerator(residual_blocks=1),
        lambda: ta.PatchDiscriminator70(), lambda: ta.NLayerDiscriminator(),
        lambda: ta.PixelDiscriminator(), lambda: ta.EDSRResBlock(8),
        lambda: ta.ResidualDenseBlock5C(8), lambda: ta.RRDB(8),
        lambda: ta.AutoEncoder(), lambda: ta.CRNAuto(),
        lambda: ta.SpatioTempoCRN(ngf=32),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert next(ta.RRDB(8, device="cpu").parameters()).device.type == "cpu"
