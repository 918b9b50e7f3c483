"""Port parity: the occlusion-boundary (edge) gradients of the SMPL
renderer (``geometry/renderer.py``): ``edge_gradient_surrogate`` and
``render_silhouettes(edge_gradients=True)`` against ``jax.grad`` of
``jafpro_tpu.geometry.renderer`` on the CPU, float32, on the single
triangle of ``tests/test_edge_gradients.py`` and a jittered
``synthetic_quad_mesh``.

Tolerances: silhouettes equal; gradients within 1e-3 relative L2 (the
surrogate multiplies map differences by the boundary pixels' weights,
which differ by ~1e-5 between the packages); the surrogate's pullback on
random maps atol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from jafpro_tpu.geometry import renderer as jr

from jafpro_tpu_torch.geometry import renderer as tr
from jafpro_tpu_torch.train.common import synthetic_quad_mesh

torch.set_num_threads(1)
GRAD_RTOL = 1e-3
S = 32
CAM = np.asarray([[1.0, 0.0, 0.0], [0.9, 0.05, -0.04]], np.float32)
# the single front-facing triangle of tests/test_edge_gradients.py
TRI = np.asarray(
    [[[-0.4, -0.5, 2.0], [-0.3, 0.6, 2.0], [0.5, -0.1, 2.0]]], np.float32)


def scene_of(name, seed=0):
    """(verts (B, V, 3), faces, cams (B, 3)): the single triangle, or
    ``synthetic_quad_mesh(6)`` jittered (no pixel centre exactly on an
    edge) in two poses."""
    if name == "triangle":
        return TRI, np.asarray([[0, 1, 2]], np.int32), CAM[:1]
    verts, faces = synthetic_quad_mesh(6)
    rng = np.random.RandomState(seed)
    v = np.stack([verts, verts]) + 0.02 * rng.randn(2, *verts.shape)
    return v.astype(np.float32), faces, CAM


def renderers(faces):
    return (jr.SMPLRenderer(faces=faces, image_size=S, chunk=16),
            tr.SMPLRenderer(faces=faces, image_size=S, device="cpu"))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("scene", ["triangle", "quad"])
def test_silhouette_edge_gradients_match_jax(scene):
    """The forward is the hard silhouette; the gradient is the edge
    surrogate's, w.r.t. vertices and camera, as ``jax.grad`` gives it."""
    verts, faces, cam = scene_of(scene, seed=2)
    j, t = renderers(faces)
    rng = np.random.RandomState(6)
    weight = (rng.rand(len(cam), S, S) + 0.5).astype(np.float32)

    def jloss(c, v):
        return jnp.sum(j.render_silhouettes(c, v, edge_gradients=True)
                       * weight)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cam), jnp.asarray(verts))
    tc = torch.from_numpy(cam).requires_grad_()
    tv = torch.from_numpy(verts).requires_grad_()
    sil = t.render_silhouettes(tc, tv, edge_gradients=True)
    np.testing.assert_array_equal(
        sil.detach().numpy(),
        np.asarray(j.render_silhouettes(jnp.asarray(cam),
                                        jnp.asarray(verts))))
    (sil * torch.from_numpy(weight)).sum().backward()
    for a, g in zip((tc, tv), jg):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        assert rel_l2(a.grad.numpy(), g) <= GRAD_RTOL
    # without the surrogate the silhouette carries no gradient
    tv2 = torch.from_numpy(verts).requires_grad_()
    assert not t.render_silhouettes(torch.from_numpy(cam), tv2).requires_grad


def test_edge_surrogate_matches_jax():
    """Zero in the forward pass; its pullback equals the JAX package's."""
    rng = np.random.RandomState(8)
    fim = rng.randint(-1, 5, (2, 8, 8)).astype(np.int32)
    wim = rng.dirichlet(np.ones(3), (2, 8, 8)).astype(np.float32)
    images = rng.rand(2, 8, 8, 3).astype(np.float32)
    px = rng.uniform(0, 8, (2, 5, 3, 2)).astype(np.float32)
    cot = rng.randn(2, 8, 8, 3).astype(np.float32)
    tpx = torch.from_numpy(px).requires_grad_()
    out = tr.edge_gradient_surrogate(torch.from_numpy(fim),
                                     torch.from_numpy(wim),
                                     torch.from_numpy(images), tpx)
    assert (out == 0).all()
    (out * torch.from_numpy(cot)).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jr.edge_gradient_surrogate(
        jnp.asarray(fim), jnp.asarray(wim), jnp.asarray(images), p) * cot))(
        jnp.asarray(px))
    np.testing.assert_allclose(tpx.grad.numpy(), np.asarray(jg), atol=1e-5)
