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


@pytest.mark.parametrize("S,n_faces", [(32, 300), (64, 1000), (100, 517)])
def test_kernel_matches_plain(cuda, S, n_faces):
    fv = torch.from_numpy(np.stack([random_faces(n_faces, s)
                                    for s in range(3)])).to(cuda)
    before = trast.rasterize_fim_wim.launches
    fim, wim = trast.rasterize_fim_wim(fv, image_size=S)
    torch.cuda.synchronize()
    assert trast.rasterize_fim_wim.launches == before + 1
    rfim, rwim = trast.rasterize_fim_wim_reference(fv, image_size=S)
    assert torch.equal(fim, rfim)
    assert (wim - rwim).abs().max().item() <= 1e-5
    assert (fim >= 0).sum().item() > 100
