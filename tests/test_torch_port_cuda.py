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
