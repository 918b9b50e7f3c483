"""Port parity: the z-buffer rasterizer's plain PyTorch version and the
SMPL flow engine of ``jafpro_tpu_torch`` against ``jafpro_tpu`` on the CPU.

The plain version is held against the Pallas kernel in interpret mode and
against the XLA rasterizer's exact mode. Face ids must be equal. Weights:
atol 1e-4. A weight is ``a*x + b*y + c`` over the winner's inverse matrix,
with terms up to ~1e2 that cancel to a value in [0, 1], so float32
rounding leaves ~1e-5 in it; XLA on the CPU contracts these products into
fused multiply-adds and PyTorch does not, so the packages differ at that
level (the JAX package's own Pallas-vs-XLA test uses the same 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jafpro_tpu.geometry.flow import SMPLFlowEngine as JEngine
from jafpro_tpu.geometry.rasterizer import rasterize_fim_wim as xla_raster
from jafpro_tpu.geometry.rasterizer_pallas import rasterize_fim_wim_pallas

from jafpro_tpu_torch.geometry import rasterizer as trast
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.utils.meshproxy import uv_sphere

torch.set_num_threads(1)
WIM_ATOL = 1e-4


def random_faces(n_faces, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_faces, 1, 3))
    offsets = rng.uniform(-0.35, 0.35, size=(n_faces, 3, 3))
    fv = (centers + offsets).astype(np.float32)
    fv[:, :, 2] = rng.uniform(1.0, 5.0, size=(n_faces, 3))
    return fv


def z_fighting_faces(seed=0):
    """Exact duplicates (ties by construction) and overlapping coplanar
    pairs at one depth, shuffled among random faces."""
    rng = np.random.RandomState(seed)
    base = random_faces(40, seed + 100)
    dup = base[:10].copy()
    flat = random_faces(10, seed + 200)
    flat[:, :, 2] = 2.5
    flat2 = flat + np.float32(0.05) * rng.uniform(-1, 1, flat.shape).astype(
        np.float32)
    flat2[:, :, 2] = 2.5
    fv = np.concatenate([base, dup, flat, flat2])
    return fv[rng.permutation(len(fv))]


def plain(fv, S, flip_y=True):
    fim, wim = trast.rasterize_fim_wim_reference(
        torch.from_numpy(fv), image_size=S, flip_y=flip_y)
    return fim.numpy(), wim.numpy()


def check(fim, wim, fim_ref, wim_ref):
    np.testing.assert_array_equal(fim, np.asarray(fim_ref))
    np.testing.assert_allclose(wim, np.asarray(wim_ref), atol=WIM_ATOL,
                               rtol=0)
    assert (wim[fim < 0] == 0).all()


@pytest.mark.parametrize("seed,n_faces", [(2, 100), (3, 300), (4, 257)])
def test_plain_matches_pallas_and_xla(seed, n_faces):
    S = 32
    fv = np.stack([random_faces(n_faces, seed),
                   random_faces(n_faces, seed + 10)])
    fim, wim = plain(fv, S)
    assert (fim >= 0).sum() > 500
    check(fim, wim, *rasterize_fim_wim_pallas(
        jnp.asarray(fv), image_size=S, block=256, rows=8, interpret=True))
    check(fim, wim, *xla_raster(jnp.asarray(fv), image_size=S, chunk=64,
                                depth_mode="exact"))


def _exact_depth(fv, f, S, xi, yi):
    """float64 perspective-correct depth of face ``f`` at pixel (xi, yi)."""
    p = 0.5 * (fv[f, :, :2].astype(np.float64) * S + S - 1)
    a = np.array([p[:, 0], p[:, 1], np.ones(3)])
    w = np.linalg.solve(a, [xi, yi, 1.0])
    return 1.0 / np.sum(w / fv[f, :, 2])


def test_plain_z_fighting_matches_pallas():
    """Coplanar overlapping pairs at one depth: both packages pick a face
    that lies at the pixel's depth. Which of two coplanar faces wins
    depends on float32 rounding (XLA contracts multiply-adds, PyTorch does
    not), so a differing id is accepted only where the two faces' exact
    depths are equal; everywhere else ids and weights must agree."""
    S = 32
    fv = z_fighting_faces()[None]
    fim, wim = plain(fv, S, flip_y=False)
    pfim, pwim = (np.asarray(a) for a in rasterize_fim_wim_pallas(
        jnp.asarray(fv), image_size=S, block=32, rows=8, flip_y=False,
        interpret=True))
    np.testing.assert_array_equal(fim >= 0, pfim >= 0)
    diff = np.argwhere(fim != pfim)
    for b, yi, xi in diff:
        d1 = _exact_depth(fv[b], fim[b, yi, xi], S, xi, yi)
        d2 = _exact_depth(fv[b], pfim[b, yi, xi], S, xi, yi)
        assert abs(d1 - d2) <= 1e-5 * d2, (b, yi, xi, d1, d2)
    same = fim == pfim
    np.testing.assert_allclose(wim[same], pwim[same], atol=WIM_ATOL, rtol=0)


def test_plain_duplicates_take_lowest_id():
    S = 24
    base = random_faces(20, 7)
    fv = np.concatenate([base, base])[None]   # face i+20 duplicates face i
    fim, wim = plain(fv, S)
    assert (fim >= 0).any() and (fim < 20).all()
    check(fim, wim, *xla_raster(jnp.asarray(fv), image_size=S,
                                depth_mode="exact"))
    check(fim, wim, *rasterize_fim_wim_pallas(
        jnp.asarray(fv), image_size=S, block=16, rows=8, interpret=True))


def test_plain_culling_band_and_flip():
    """A scene squeezed into one band, unflipped, against both."""
    S = 32
    fv = random_faces(64, seed=5)
    fv[:, :, 1] = fv[:, :, 1] * 0.1 + 0.5
    fv = fv[None]
    fim, wim = plain(fv, S, flip_y=False)
    check(fim, wim, *xla_raster(jnp.asarray(fv), image_size=S, chunk=16,
                                flip_y=False))
    check(fim, wim, *rasterize_fim_wim_pallas(
        jnp.asarray(fv), image_size=S, block=16, rows=8, flip_y=False,
        interpret=True))


def test_plain_near_far_and_degenerate():
    """Faces crossing the near and far planes, degenerate (zero-area)
    faces and back faces."""
    S = 32
    fv = random_faces(120, seed=11)
    fv[:20, :, 2] = np.float32([0.05, 0.3, 0.2])      # crosses near
    fv[20:40, :, 2] = np.float32([24.0, 30.0, 26.0])  # crosses far
    fv[40:45, 1:] = fv[40:45, :1]                      # a point
    fv[45:50, 2] = 0.5 * (fv[45:50, 0] + fv[45:50, 1])  # collinear
    fv[50:70] = fv[50:70, ::-1]                        # flipped winding
    fv = fv[None]
    fim, wim = plain(fv, S)
    check(fim, wim, *rasterize_fim_wim_pallas(
        jnp.asarray(fv), image_size=S, block=32, rows=8, interpret=True))


def test_prepare_faces_layout():
    fv = torch.from_numpy(random_faces(300, 1))[None].repeat(2, 1, 1, 1)
    prep = trast.prepare_faces(fv, 32)
    assert prep.faces.shape == (2, trast.NF, 512)
    assert prep.extent.shape == (2, 2, 4)
    assert prep.faces.is_contiguous()
    assert (prep.faces[:, 18, 300:] == 0).all()   # padding is never valid
    # every block's box holds its front faces
    y = prep.faces[:, 3:6].amin(1)
    front = prep.faces[:, 18] > 0
    assert (y[:, :256][front[:, :256]] >= prep.extent[:, 0, 0:1].expand(
        -1, 256)[front[:, :256]]).all()


def test_wrapper_dispatch_and_checks():
    fv = torch.from_numpy(random_faces(50, 3))[None]
    before = trast.rasterize_fim_wim.launches
    got = trast.rasterize_fim_wim(fv, image_size=16)
    want = trast.rasterize_fim_wim_reference(fv, image_size=16)
    assert trast.rasterize_fim_wim.launches == before   # CPU: no kernel
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    with pytest.raises(TypeError):
        trast.rasterize_fim_wim(fv.double(), image_size=16)
    with pytest.raises(ValueError):
        trast.rasterize_fim_wim(fv[:, :, :2], image_size=16)


def test_cuda_path_needs_cuda_tensors():
    """The kernel entry refuses CPU tensors instead of falling back."""
    prep = trast.prepare_faces(torch.from_numpy(random_faces(10))[None], 16)
    with pytest.raises(ValueError):
        trast.rasterize_prepared_cuda(prep, 16, 0.1, 25.0)


def test_uv_sphere_counts():
    verts, faces = uv_sphere()
    assert verts.shape == (6890, 3) and faces.shape == (13776, 3)
    # closed: every edge is shared by exactly two faces
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()


def _scene(T=3, S=32):
    verts0, faces = uv_sphere(8, 10)
    rng = np.random.RandomState(0)
    base = verts0 * np.float32([0.35, 0.9, 0.35])
    verts = (base[None] + rng.normal(scale=0.02, size=(T, 1, 3))).astype(
        np.float32)
    verts[..., 2] += 2.0
    cams = np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1))
    cams[:, 0] += rng.uniform(-0.1, 0.1, T).astype(np.float32)
    return faces, verts, cams


def test_flow_engine_matches_jax():
    S = 32
    faces, verts, cams = _scene(S=S)
    rng = np.random.RandomState(1)
    src = rng.uniform(-1, 1, (3, S, S, 3)).astype(np.float32)
    jeng = JEngine(faces=faces, image_size=S, backend="xla", band_rows=0,
                   depth_mode="exact")
    teng = SMPLFlowEngine(faces=faces, image_size=S)
    tv, tc = torch.from_numpy(verts), torch.from_numpy(cams)
    jv, jc = jnp.asarray(verts), jnp.asarray(cams)

    np.testing.assert_allclose(teng.project_faces(tc, tv).numpy(),
                               np.asarray(jeng.project_faces(jc, jv)),
                               atol=1e-5, rtol=0)
    _, fim, wim = teng.render_fim_wim(tc, tv)
    _, jfim, jwim = jeng.render_fim_wim(jc, jv)
    check(fim.numpy(), wim.numpy(), jfim, jwim)
    assert (fim.numpy() >= 0).mean() > 0.1

    src_order = [2, 0, 1]
    flow = teng.cal_flow(tc[src_order], tv[src_order], tc, tv)
    jflow = jeng.cal_flow(jc[np.array(src_order)], jv[np.array(src_order)],
                          jc, jv)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=1e-4,
                               rtol=0)
    tsf = teng(torch.from_numpy(src).permute(0, 3, 1, 2), tc[src_order],
               tv[src_order], tc, tv)
    jtsf = jeng(jnp.asarray(src), jc[np.array(src_order)],
                jv[np.array(src_order)], jc, jv)
    np.testing.assert_allclose(tsf.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jtsf), atol=1e-3, rtol=0)


def test_flow_engine_create_needs_faces(monkeypatch):
    monkeypatch.setenv("JAFPRO_SMPL_FACES", "")
    with pytest.raises(FileNotFoundError):
        SMPLFlowEngine.create(image_size=32)
    faces = uv_sphere(4, 6)[1]
    eng = SMPLFlowEngine.create(faces=faces, image_size=16)
    assert dataclasses.asdict(eng)["image_size"] == 16
    assert eng.faces.dtype == np.int32
