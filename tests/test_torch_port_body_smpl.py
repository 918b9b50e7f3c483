"""Port parity: SMPL (``geometry/smpl.py``) against ``jafpro_tpu`` on
the CPU, float32: the synthetic model and one read from a pkl.

Tolerance: vertices, joints and rotations atol 1e-5 (the same float32 ops
in another summation order).
"""

import pickle

import numpy as np
import pytest
import scipy.sparse
import torch
import jax.numpy as jnp

from jafpro_tpu.geometry import smpl as jsmpl

from jafpro_tpu_torch.geometry import smpl as tsmpl

torch.set_num_threads(1)
SMPL_ATOL = 1e-5


def poses(n, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    beta = rng.randn(n, 10).astype(np.float32)
    theta = (scale * rng.randn(n, 72)).astype(np.float32)
    return beta, theta


def test_batch_rodrigues_matches_jax():
    theta = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    theta[0] = 0.0                                   # the 1e-8 regulariser
    np.testing.assert_allclose(
        tsmpl.batch_rodrigues(torch.from_numpy(theta)).numpy(),
        np.asarray(jsmpl.batch_rodrigues(jnp.asarray(theta))), atol=1e-6)


@pytest.mark.parametrize("get_skin", [True, False])
def test_smpl_synthetic_matches_jax(get_skin):
    jm = jsmpl.SMPLModel.synthetic(num_verts=64, seed=3)
    tm = tsmpl.SMPLModel.synthetic(num_verts=64, seed=3, device="cpu")
    np.testing.assert_array_equal(tm.posedirs.numpy(), np.asarray(jm.posedirs))
    beta, theta = poses(4, 1)
    jout = jm(jnp.asarray(beta), jnp.asarray(theta), get_skin=get_skin)
    tout = tm(torch.from_numpy(beta), torch.from_numpy(theta),
              get_skin=get_skin)
    if not get_skin:
        jout, tout = (jout,), (tout,)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SMPL_ATOL)


def test_smpl_synthetic_given_template():
    """A given template (the card's sphere) keeps the seed's other draws."""
    vt = np.random.RandomState(9).randn(64, 3).astype(np.float32)
    a = tsmpl.SMPLModel.synthetic(num_verts=64, seed=2, device="cpu")
    b = tsmpl.SMPLModel.synthetic(seed=2, v_template=vt,
                                  faces=np.zeros((5, 3)), device="cpu")
    np.testing.assert_array_equal(b.v_template.numpy(), vt)
    np.testing.assert_array_equal(a.posedirs.numpy(), b.posedirs.numpy())
    assert b.faces.shape == (5, 3) and b.faces.dtype == np.int32


def test_smpl_from_pkl_matches_jax(tmp_path):
    """A plain pkl in SMPL's layout with scipy sparse regressors."""
    rng = np.random.RandomState(4)
    V = 40
    Jr = rng.rand(24, V) * (rng.rand(24, V) > 0.7)
    dd = {
        "v_template": rng.randn(V, 3),
        "shapedirs": 0.01 * rng.randn(V, 3, 10),
        "posedirs": 0.001 * rng.randn(V, 3, 207),
        "J_regressor": scipy.sparse.csc_matrix(Jr / Jr.sum(1, keepdims=True)),
        "weights": rng.dirichlet(np.ones(24), V),
        "kintree_table": np.stack([np.r_[-1, np.arange(23)],
                                   np.arange(24)]),
        "cocoplus_regressor": scipy.sparse.csc_matrix(
            rng.rand(19, V) / V),
        "f": rng.randint(0, V, (30, 3)),
    }
    path = str(tmp_path / "smpl.pkl")
    with open(path, "wb") as f:
        pickle.dump(dd, f)
    jm = jsmpl.SMPLModel.from_pkl(path)
    tm = tsmpl.SMPLModel.from_pkl(path, device="cpu")
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tm.parents, jm.parents)
    beta, theta = poses(3, 2)
    for a, b in zip(tm(torch.from_numpy(beta), torch.from_numpy(theta)),
                    jm(jnp.asarray(beta), jnp.asarray(theta))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=SMPL_ATOL)


def test_body_entry_points_refuse_missing_cuda(monkeypatch):
    """Without CUDA the body path's entry points, called without a
    ``device``, raise instead of running on the CPU."""
    from jafpro_tpu_torch.geometry.renderer import SMPLRenderer
    from jafpro_tpu_torch.geometry.uvmap import fit_uv_image
    from jafpro_tpu_torch.lpips import LPIPS
    from jafpro_tpu_torch.models.hmr import HumanModelRecovery

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tsmpl.SMPLModel.synthetic(num_verts=8),
        lambda: HumanModelRecovery((1, 1, 1, 1)),
        lambda: SMPLRenderer(faces=np.zeros((1, 3), np.int32)),
        lambda: LPIPS(),
        lambda: fit_uv_image(np.zeros((2, 9, 2), np.float32),
                             np.zeros((2, 3, 3, 3), np.float32), 4, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
