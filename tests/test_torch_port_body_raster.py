"""Port parity: the rasterizer's depth output and its vertex gradients
(``jafpro_tpu_torch.geometry.rasterizer``) against the XLA rasterizer of
``jafpro_tpu`` (``rasterize_fim_wim(return_depth=True)``, exact mode) on
the CPU, where the port runs its plain version.

Tolerances: face ids equal, except at pixels where two coplanar faces
z-fight (each package picks by its own float32 rounding; both winners lie
at the pixel's depth). Weights atol 1e-4 (XLA contracts multiply-adds into
FMAs and PyTorch does not, ~1e-5 apart; as ``test_torch_port_rasterizer``).
Depth within 1e-5 relative: the port divides by each z where the XLA
rasterizer multiplies by a precomputed 1/z, on weights ~1e-5 apart.
Gradients of a random linear functional of (wim, dim) w.r.t. the
triangles within 1e-4 relative L2 of ``jax.grad``'s.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from jafpro_tpu.geometry.rasterizer import rasterize_fim_wim as xla_raster

from jafpro_tpu_torch.geometry import rasterizer as trast
from jafpro_tpu_torch.utils.meshproxy import degenerate_faces

torch.set_num_threads(1)
WIM_ATOL = 1e-4
DEPTH_RTOL = 1e-5
GRAD_RTOL = 1e-4


def random_faces(n_faces, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_faces, 1, 3))
    offsets = rng.uniform(-0.35, 0.35, size=(n_faces, 3, 3))
    fv = (centers + offsets).astype(np.float32)
    fv[:, :, 2] = rng.uniform(1.0, 5.0, size=(n_faces, 3))
    return fv


def z_fighting_faces(seed=0):
    """Random faces with coplanar overlapping pairs at one depth."""
    rng = np.random.RandomState(seed)
    flat = random_faces(10, seed + 200)
    flat[:, :, 2] = 2.5
    flat2 = flat + np.float32(0.05) * rng.uniform(-1, 1, flat.shape).astype(
        np.float32)
    flat2[:, :, 2] = 2.5
    fv = np.concatenate([random_faces(40, seed + 100), flat, flat2])
    return fv[rng.permutation(len(fv))]


def exact_depth(fv, f, S, xi, yi):
    """float64 perspective-correct depth of face ``f`` at pixel (xi, yi)."""
    p = 0.5 * (fv[f, :, :2].astype(np.float64) * S + S - 1)
    a = np.array([p[:, 0], p[:, 1], np.ones(3)])
    w = np.linalg.solve(a, [xi, yi, 1.0])
    return 1.0 / np.sum(w / fv[f, :, 2])


SCENES = {
    "random": lambda: np.stack([random_faces(200, 1), random_faces(200, 2)]),
    "z_fighting": lambda: z_fighting_faces()[None],
    "degenerate": lambda: degenerate_faces(seed=11)[None],
}


@pytest.mark.parametrize("flip_y", [True, False])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_depth_matches_xla(scene, flip_y):
    S = 32
    fv = SCENES[scene]()
    fim, wim, dim = (t.numpy() for t in trast.rasterize_fim_wim(
        torch.from_numpy(fv), S, flip_y=flip_y, return_depth=True))
    jf, jw, jd = (np.asarray(a) for a in xla_raster(
        jnp.asarray(fv), image_size=S, chunk=64, flip_y=flip_y,
        return_depth=True))
    assert (fim >= 0).sum() > 50
    np.testing.assert_array_equal(fim >= 0, jf >= 0)
    assert (dim[fim < 0] == 0).all() and (dim[fim >= 0] > 0).all()
    for b, r, c in np.argwhere(fim != jf):
        row = S - 1 - r if flip_y else r
        d1 = exact_depth(fv[b], fim[b, r, c], S, c, row)
        d2 = exact_depth(fv[b], jf[b, r, c], S, c, row)
        assert abs(d1 - d2) <= 1e-5 * d2, (scene, b, r, c)
    same = fim == jf
    assert same.all() or scene == "z_fighting"
    np.testing.assert_allclose(wim[same], jw[same], atol=WIM_ATOL, rtol=0)
    np.testing.assert_allclose(dim[same], jd[same], rtol=DEPTH_RTOL, atol=0)
    # without return_depth: the same maps, two outputs
    f2, w2 = trast.rasterize_fim_wim(torch.from_numpy(fv), S, flip_y=flip_y)
    np.testing.assert_array_equal(f2.numpy(), fim)
    np.testing.assert_array_equal(w2.numpy(), wim)


@pytest.mark.parametrize("flip_y", [True, False])
def test_weight_and_depth_gradients_match_jax(flip_y):
    S = 32
    fv = np.stack([random_faces(120, 3), random_faces(120, 4)])
    rng = np.random.RandomState(5)
    gw = rng.randn(2, S, S, 3).astype(np.float32)
    gd = rng.randn(2, S, S).astype(np.float32)

    t = torch.from_numpy(fv).requires_grad_()
    fim, wim, dim = trast.rasterize_fim_wim(t, S, flip_y=flip_y,
                                            return_depth=True)
    # the forward values are the rasterizer's own, gradient or not
    f0, w0, d0 = trast.rasterize_fim_wim(torch.from_numpy(fv), S,
                                         flip_y=flip_y, return_depth=True)
    assert torch.equal(fim, f0) and torch.equal(wim, w0) and torch.equal(
        dim, d0)
    ((wim * torch.from_numpy(gw)).sum()
     + (dim * torch.from_numpy(gd)).sum()).backward()

    def loss(x):
        _, w, d = xla_raster(x, image_size=S, chunk=64, flip_y=flip_y,
                             return_depth=True)
        return jnp.sum(w * gw) + jnp.sum(d * gd)

    jg = np.asarray(jax.grad(loss)(jnp.asarray(fv)))
    tg = t.grad.numpy()
    assert np.abs(jg).max() > 1.0
    assert np.linalg.norm(tg - jg) <= GRAD_RTOL * np.linalg.norm(jg)


def test_weight_gradient_without_depth():
    """``return_depth=False`` with a gradient: only the weights' term."""
    S = 24
    fv = random_faces(80, 6)[None]
    gw = np.random.RandomState(7).randn(1, S, S, 3).astype(np.float32)
    t = torch.from_numpy(fv).requires_grad_()
    _, wim = trast.rasterize_fim_wim(t, S)
    (wim * torch.from_numpy(gw)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(xla_raster(
        x, image_size=S, chunk=64)[1] * gw))(jnp.asarray(fv))
    jg = np.asarray(jg)
    assert np.linalg.norm(t.grad.numpy() - jg) <= GRAD_RTOL * np.linalg.norm(
        jg)


@pytest.mark.parametrize("flip_y", [True, False])
def test_recompute_equals_forward(flip_y):
    """``winner_weights_depth`` for the rasterizer's own face ids gives its
    weights (same arithmetic: equal to 1e-6) and depth (the JAX order of
    the division: within 1e-6 relative)."""
    S = 32
    fv = torch.from_numpy(np.stack([random_faces(150, 8),
                                    random_faces(150, 9)]))
    fim, wim, dim = trast.rasterize_fim_wim(fv, S, flip_y=flip_y,
                                            return_depth=True)
    w2, d2 = trast.winner_weights_depth(fv, fim, S, flip_y)
    assert (w2 - wim).abs().max().item() <= 1e-6
    found = fim >= 0
    assert (d2[~found] == 0).all()
    rel = ((d2 - dim).abs() / dim.clamp(min=1e-30))[found]
    assert rel.max().item() <= 1e-6


def test_no_gradient_no_recompute(monkeypatch):
    """A tensor without a gradient, or grad mode off, skips the recompute
    (the main path's launches and outputs do not change)."""
    calls = []
    monkeypatch.setattr(trast._WinnerGrad, "apply",
                        lambda *a: calls.append(1) or a[4])
    fv = torch.from_numpy(random_faces(50, 10)[None])
    trast.rasterize_fim_wim(fv, 16, return_depth=True)
    with torch.no_grad():
        trast.rasterize_fim_wim(fv.clone().requires_grad_(), 16)
    assert not calls
    _, wim = trast.rasterize_fim_wim(fv.clone().requires_grad_(), 16)
    assert calls == [1]


@pytest.mark.parametrize("outputs", ["wim", "dim", "both"])
def test_gradient_of_each_output(outputs):
    """The rasterizer's vertex gradient equals autograd through
    ``winner_weights_depth`` for the same face ids, whether the loss reads
    wim alone (no depth output), dim alone or both (1e-6 relative L2)."""
    S = 24
    rng = np.random.RandomState(11)
    fv = torch.from_numpy(random_faces(80, 12)[None])
    gw = torch.from_numpy(rng.randn(1, S, S, 3).astype(np.float32))
    gd = torch.from_numpy(rng.randn(1, S, S).astype(np.float32))

    def loss(wim, dim):
        return ((wim * gw).sum() if outputs != "dim" else 0) + (
            (dim * gd).sum() if outputs != "wim" else 0)

    t = fv.clone().requires_grad_()
    out = trast.rasterize_fim_wim(t, S, return_depth=outputs != "wim")
    loss(out[1], out[2] if len(out) == 3 else None).backward()
    r = fv.clone().requires_grad_()
    loss(*trast.winner_weights_depth(r, out[0], S)).backward()
    assert r.grad.norm() > 0
    assert (t.grad - r.grad).norm() <= 1e-6 * r.grad.norm()
