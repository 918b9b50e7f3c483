"""The port's CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided
inside the test). Run on a GPU host with
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest``
(``tests/conftest.py`` imports JAX, which a GPU host need not have).
"""

import numpy as np
import pytest
import torch

from jafpro_tpu_torch.geometry import rasterizer as trast
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.utils.meshproxy import ellipsoid_clip, sliver_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_faces(n_faces, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_faces, 1, 3))
    offsets = rng.uniform(-0.35, 0.35, size=(n_faces, 3, 3))
    fv = (centers + offsets).astype(np.float32)
    fv[:, :, 2] = rng.uniform(1.0, 5.0, size=(n_faces, 3))
    return fv


def shuffled_sphere(T=3):
    """The clip's 13776-face mesh with its faces in a seeded random order."""
    verts, cams, faces = ellipsoid_clip(T, shuffle=True)
    return SMPLFlowEngine(faces=faces, image_size=256).project_faces(
        torch.from_numpy(cams), torch.from_numpy(verts)).numpy()


SCENES = {
    "random": lambda S, n: np.stack([random_faces(n, s) for s in range(3)]),
    "shuffled_sphere": lambda S, n: shuffled_sphere(),
    "slivers": lambda S, n: np.stack([sliver_scene(S, seed=s)
                                      for s in range(2)]),
}


@pytest.mark.parametrize("scene,S,n_faces", [
    ("random", 32, 300), ("random", 64, 1000), ("random", 100, 517),
    ("shuffled_sphere", 256, 13776), ("slivers", 256, 768)])
def test_kernel_matches_plain(cuda, scene, S, n_faces):
    fv = torch.from_numpy(SCENES[scene](S, n_faces)).to(cuda)
    assert fv.shape[1] == n_faces
    before = trast.rasterize_fim_wim.launches
    fim, wim = trast.rasterize_fim_wim(fv, image_size=S)
    torch.cuda.synchronize()
    assert trast.rasterize_fim_wim.launches == before + 1
    rfim, rwim = trast.rasterize_fim_wim_reference(fv, image_size=S)
    assert torch.equal(fim, rfim)
    assert (wim - rwim).abs().max().item() <= 1e-5
    assert (fim >= 0).sum().item() > 100


def test_generate_batch_one_launch_on_card(cuda):
    """Two clips as one ``generate_batch`` pass rasterize in one launch and
    equal the clips generated one by one (float32, TF32 off)."""
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.infer import VideoGenerator, stack_clips
    from jafpro_tpu_torch.pipeline import JAFProPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    S, p, R, T = 64, 32, 2, 4
    clips = []
    for seed in (0, 1):
        verts, cams, faces = ellipsoid_clip(T, seed)
        rng = np.random.RandomState(seed)
        iuv = rng.randint(0, 25, (T, S, S, 3)).astype(np.uint8)
        clips.append({
            "src_parts": rng.uniform(-1, 1, (1, R, 24, p, p, 3)),
            "src_mask_parts": (rng.rand(1, R, 24, p, p) > 0.5) * 1.0,
            "ref_mask": np.ones((1, R)),
            "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)),
            "src_imgs": rng.uniform(-1, 1, (R, S, S, 3)),
            "chosen_frames": np.array([seed, T - 1], np.int32),
            "tgt_iuv255": iuv, "smpl_mask": np.ones((T, S, S, 1)),
            "cams": cams, "verts": verts})
    cfg = Config(image_size=S, part_size=p, maximum_ref_frames=R,
                 compute_dtype="float32")
    pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
        faces=faces, image_size=S), device=cuda)
    gen = VideoGenerator(pipe, frame_batch=T, flow_mode="batch")
    singles = [gen(c) for c in clips]
    before = trast.rasterize_fim_wim.launches
    batch = gen.generate_batch(stack_clips(clips))
    torch.cuda.synchronize()
    assert trast.rasterize_fim_wim.launches == before + 1
    for k in ("final", "coarse", "mask", "tsf"):
        for i in range(2):
            d = (batch[k][i] - singles[i][k]).abs().max().item()
            assert d <= 1e-4, (k, i, d)
