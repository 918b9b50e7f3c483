"""Port parity: the SMPL renderer (``geometry/renderer.py``) against
``jafpro_tpu.geometry.renderer`` on the CPU, float32: every map, texture
extraction, lighting, the textured render, and the gradients of
``render`` (w.r.t. textures, vertices and camera, with and without the
edge term) against ``jax.grad`` on the same inputs. The silhouettes' edge
gradients are in ``test_torch_port_body_edges.py``.

The port's images are NCHW; the JAX package's NHWC arrays are permuted
for the comparison. Tolerances: face ids equal; weights, depths and
images atol 1e-4 (the rasterizer's weights differ by ~1e-5 between the
packages, FMA contraction); gradients within 1e-3 relative L2 (the edge
term multiplies image differences by vertex weights; the interior term
goes through the recomputed weights and depth).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from jafpro_tpu.geometry import renderer as jr
from jafpro_tpu.train.common import synthetic_quad_mesh as jquad

from jafpro_tpu_torch.geometry import renderer as tr
from jafpro_tpu_torch.train.common import synthetic_quad_mesh

torch.set_num_threads(1)
ATOL = 1e-4
GRAD_RTOL = 1e-3
S = 32
CAM = np.asarray([[1.0, 0.0, 0.0], [0.9, 0.05, -0.04]], np.float32)
# the single front-facing triangle of tests/test_edge_gradients.py
TRI = np.asarray(
    [[[-0.4, -0.5, 2.0], [-0.3, 0.6, 2.0], [0.5, -0.1, 2.0]]], np.float32)


def quad_scene(jitter=0.02, seed=0):
    """``synthetic_quad_mesh(6)`` with its vertices jittered (so no pixel
    centre lies exactly on an edge), two poses."""
    verts, faces = synthetic_quad_mesh(6)
    np.testing.assert_array_equal(faces, jquad(6)[1])
    rng = np.random.RandomState(seed)
    v = np.stack([verts, verts]) + jitter * rng.randn(2, *verts.shape)
    return v.astype(np.float32), faces


def renderers(faces, **kw):
    return (jr.SMPLRenderer(faces=faces, image_size=S, chunk=16, **kw),
            tr.SMPLRenderer(faces=faces, image_size=S, device="cpu", **kw))


def textures(B, F, seed=1):
    return np.random.RandomState(seed).uniform(
        0, 1, (B, F, 3, 3, 3, 3)).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_encode_fim_sampler_and_coords():
    fim = np.asarray([[[0, -1], [1, 0]]], np.int32)
    map_fn = np.asarray([[1.0, 2.0], [3.0, 4.0], [9.0, 9.0]], np.float32)
    close(tr.encode_fim(torch.from_numpy(fim), torch.from_numpy(map_fn)),
          jr.encode_fim(jnp.asarray(fim), jnp.asarray(map_fn)), 0)
    for T in (1, 2, 3, 4):
        np.testing.assert_array_equal(tr.create_coords(T),
                                      jr.create_coords(T))
    pts = np.random.RandomState(0).uniform(-1.3, 1.3, (2, 7, 3, 2)).astype(
        np.float32)
    coords = jr.create_coords(3)
    close(tr.points_to_sampler(torch.from_numpy(coords),
                               torch.from_numpy(pts)),
          jr.points_to_sampler(jnp.asarray(coords), jnp.asarray(pts)), 1e-6)


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_maps_match_jax(jitter):
    """render_fim_wim, render_fim, render_silhouettes and render_depth."""
    verts, faces = quad_scene(jitter)
    j, t = renderers(faces)
    cam, v = jnp.asarray(CAM), jnp.asarray(verts)
    tc, tv = torch.from_numpy(CAM), torch.from_numpy(verts)
    jfv, jfim, jwim = j.render_fim_wim(cam, v)
    tfv, tfim, twim = t.render_fim_wim(tc, tv)
    close(tfv, jfv, 1e-6)
    np.testing.assert_array_equal(tfim.numpy(), np.asarray(jfim))
    close(twim, jwim)
    np.testing.assert_array_equal(t.render_fim(tc, tv).numpy(),
                                  np.asarray(jfim))
    sil = t.render_silhouettes(tc, tv)
    np.testing.assert_array_equal(sil.numpy(),
                                  np.asarray(j.render_silhouettes(cam, v)))
    assert 50 < sil[0].sum() < S * S
    depth = t.render_depth(tc, tv)
    jd = np.asarray(j.render_depth(cam, v))
    np.testing.assert_allclose(depth.numpy(), jd, rtol=1e-5, atol=0)
    assert (depth.numpy()[sil.numpy() == 0] == 0).all()


def test_texture_extraction_matches_jax():
    verts, faces = quad_scene()
    j, t = renderers(faces)
    img = np.random.RandomState(3).uniform(-1, 1, (2, S, S, 3)).astype(
        np.float32)
    cam, v = jnp.asarray(CAM), jnp.asarray(verts)
    tc, tv = torch.from_numpy(CAM), torch.from_numpy(verts)
    samp = t.dynamic_sampler(tc, tv)
    close(samp, j.dynamic_sampler(cam, v), 1e-6)
    timg = torch.from_numpy(img).permute(0, 3, 1, 2)
    tex = t.extract_tex(timg, samp)
    assert tex.shape == (2, len(faces), 3, 3, 3, 3)
    close(tex, j.extract_tex(jnp.asarray(img), j.dynamic_sampler(cam, v)),
          1e-5)
    close(t.extract_tex_from_image(timg, tc, tv),
          j.extract_tex_from_image(jnp.asarray(img), cam, v), 1e-5)


def test_lighting_matches_jax():
    verts, faces = quad_scene()
    kw = dict(light_intensity_ambient=0.6, light_intensity_directional=0.5,
              light_color_directional=(1.0, 0.8, 0.6),
              light_direction=(0.3, 0.5, -0.8))
    j, t = renderers(faces, **kw)
    fv = verts[:, faces]
    tex = textures(2, len(faces))
    close(t.lighting(torch.from_numpy(fv), torch.from_numpy(tex)),
          j.lighting(jnp.asarray(fv), jnp.asarray(tex)), 1e-6)


def scene_of(name, seed=0):
    """(verts (B, V, 3), faces, cams (B, 3)): the single triangle of
    ``tests/test_edge_gradients.py`` or the jittered quad mesh."""
    if name == "triangle":
        return TRI, np.asarray([[0, 1, 2]], np.int32), CAM[:1]
    return (*quad_scene(seed=seed), CAM)


@pytest.mark.parametrize("edge_gradients", [False, True])
@pytest.mark.parametrize("scene", ["triangle", "quad"])
def test_render_matches_jax(scene, edge_gradients):
    """Forward (with lighting and get_fim) and the gradients w.r.t.
    textures, vertices and camera."""
    verts, faces, cam = scene_of(scene)
    B = len(cam)
    kw = dict(light_intensity_ambient=0.7, light_intensity_directional=0.4,
              light_direction=(0.0, 0.6, -0.8))
    j, t = renderers(faces, **kw)
    tex = textures(B, len(faces))
    weight = np.random.RandomState(4).randn(B, S, S, 3).astype(np.float32)

    def jloss(cam, v, x):
        img = j.render(cam, v, x, edge_gradients=edge_gradients)
        return jnp.sum(img * weight)

    jimg, jfim = j.render(jnp.asarray(cam), jnp.asarray(verts),
                          jnp.asarray(tex), get_fim=True,
                          edge_gradients=edge_gradients)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(cam), jnp.asarray(verts), jnp.asarray(tex))

    args = [torch.from_numpy(a).requires_grad_() for a in (cam, verts, tex)]
    img, fim = t.render(*args, get_fim=True, edge_gradients=edge_gradients)
    assert img.shape == (B, 3, S, S)
    np.testing.assert_array_equal(fim.numpy(), np.asarray(jfim))
    close(img.permute(0, 2, 3, 1), jimg)
    (img * torch.from_numpy(weight).permute(0, 3, 1, 2)).sum().backward()
    for name, a, g in zip(("cam", "verts", "textures"), args, jg):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, name
        assert rel_l2(a.grad.numpy(), g) <= GRAD_RTOL, name
