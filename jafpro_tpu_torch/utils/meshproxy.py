"""Topology-consistent proxy vertices for the SMPL face graph
(a copy of ``jafpro_tpu/utils/meshproxy.py``, plus ``uv_sphere``).

The environment ships the SMPL *topology* (``smpl_faces.npy``) but not the
SMPL body model, so nothing here can pose a real body.  Occupancy planning
and benchmarking still need meshes whose triangles have realistic pixel
extents: assigning independent random positions to vertices makes every
triangle span the whole blob (graph-adjacent vertices land far apart),
which both overstates band occupancy and bears no resemblance to a body
surface.

``smoothed_topology_vertices`` produces a smooth embedding of the face
graph instead: start from random positions and repeatedly average each
vertex with its graph neighbors (graph-Laplacian smoothing, re-normalized
each step so the embedding doesn't collapse).  Adjacent vertices converge
to nearby points, so triangles become small, and regions where the
topology is dense (head, hands) stay dense in space — the properties that
drive per-band face counts on real bodies.
"""

from __future__ import annotations

import numpy as np


def smoothed_topology_vertices(
    faces: np.ndarray,
    iters: int = 80,
    seed: int = 0,
    aspect: tuple = (0.35, 1.0, 0.35),
) -> np.ndarray:
    """(V, 3) smooth embedding of the face graph, scaled to ``aspect``
    (default: a body-like upright ellipsoid filling [-1, 1] in y).

    faces: (F, 3) int vertex ids."""
    faces = np.asarray(faces, np.int64)
    V = int(faces.max()) + 1
    # undirected edge list from face edges
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    deg = np.bincount(src, minlength=V).astype(np.float64)[:, None]
    deg = np.maximum(deg, 1.0)

    rng = np.random.RandomState(seed)
    x = rng.normal(size=(V, 3))
    for _ in range(iters):
        nbr = np.zeros((V, 3))
        np.add.at(nbr, src, x[dst])
        x = 0.5 * x + 0.5 * nbr / deg
        x -= x.mean(axis=0)
        x /= np.sqrt((x ** 2).sum(axis=1).mean())  # unit RMS radius
    # scale each axis so the embedding spans roughly [-a, a] per axis
    ext = np.abs(x).max(axis=0)
    x = x / ext * np.asarray(aspect, np.float64)
    return x.astype(np.float32)


def uv_sphere(rings: int = 84, segments: int = 82) -> tuple:
    """Closed genus-0 UV sphere: ``rings`` latitude rings of ``segments``
    vertices plus two poles. The defaults give SMPL's counts exactly:
    V = 84*82 + 2 = 6890 and F = 2*82 + 2*82*83 = 13776.

    Returns (verts (V, 3) float32 on the unit sphere, faces (F, 3) int32),
    faces wound outward-facing and ordered pole to pole, ring by ring."""
    theta = np.pi * np.arange(1, rings + 1) / (rings + 1)   # polar angle
    phi = 2.0 * np.pi * np.arange(segments) / segments
    ring = np.stack([
        np.sin(theta)[:, None] * np.cos(phi)[None],
        np.cos(theta)[:, None] * np.ones_like(phi)[None],
        np.sin(theta)[:, None] * np.sin(phi)[None],
    ], axis=-1).reshape(-1, 3)
    top, bottom = 0, rings * segments + 1
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])

    def vid(r, s):
        return 1 + r * segments + s % segments

    faces = []
    for s in range(segments):
        faces.append([top, vid(0, s + 1), vid(0, s)])
    for r in range(rings - 1):
        for s in range(segments):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s), vid(r + 1, s + 1)
            faces.append([a, b, c])
            faces.append([b, d, c])
    for s in range(segments):
        faces.append([bottom, vid(rings - 1, s), vid(rings - 1, s + 1)])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def ellipsoid_clip(T: int, seed: int = 0, shuffle: bool = False) -> tuple:
    """The clip mesh of the port's kernel checks: ``uv_sphere()`` (SMPL's
    counts) as an upright ellipsoid (0.35, 0.9, 0.35) at z = 2, jittered
    per pose by N(0, 0.01), seen by a unit weak-perspective camera. Faces
    are in the mesh's own ring-by-ring order, or in a seeded random order
    with ``shuffle``.

    Returns (verts (T, V, 3) float32, cams (T, 3) float32, faces (F, 3))."""
    verts0, faces = uv_sphere()
    rng = np.random.RandomState(seed)
    verts = (verts0 * np.float32([0.35, 0.9, 0.35])
             + rng.normal(scale=0.01, size=(T, 1, 3))).astype(np.float32)
    verts[..., 2] += 2.0
    if shuffle:
        faces = faces[rng.permutation(len(faces))]
    cams = np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1))
    return verts, cams, faces


def degenerate_faces(seed: int = 0) -> np.ndarray:
    """(120, 3, 3) float32 random view-space triangles at z in [1, 5] of
    which 20 cross the near plane, 20 cross the far plane, 5 are points, 5
    are exactly collinear and 20 are wound backwards."""
    n_faces = 120
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_faces, 1, 3))
    offsets = rng.uniform(-0.35, 0.35, size=(n_faces, 3, 3))
    fv = (centers + offsets).astype(np.float32)
    fv[:, :, 2] = rng.uniform(1.0, 5.0, size=(n_faces, 3))
    fv[:20, :, 2] = np.float32([0.05, 0.3, 0.2])       # crosses near
    fv[20:40, :, 2] = np.float32([24.0, 30.0, 26.0])   # crosses far
    fv[40:45, 1:] = fv[40:45, :1]                       # points
    fv[45:50, 2] = 0.5 * (fv[45:50, 0] + fv[45:50, 1])  # collinear
    fv[50:70] = fv[50:70, ::-1]                         # back faces
    return fv


def _sliver(rng: np.random.RandomState, v0: np.ndarray, v1: np.ndarray,
            lo: float, hi: float) -> np.ndarray:
    """A near-collinear (3, 2) sliver: v0, v1 and a third vertex off their
    midpoint by 10**U(lo, hi) of their distance."""
    off = 10.0 ** rng.uniform(lo, hi)
    normal = np.array([v0[1] - v1[1], v1[0] - v0[0]])
    return np.stack([v0, v1,
                     0.5 * (v0 + v1) + off * rng.choice([-1, 1]) * normal])


def sliver_scene(image_size: int, seed: int = 0) -> np.ndarray:
    """(768, 3, 3) float32 view-space triangles full of the
    rasterizer's hard cases, for checking a culled kernel against the
    dense version.

    The first block of 256 faces holds ``degenerate_faces(seed)`` and
    136 near-collinear slivers in front of them (z in [0.5, 1]); two in
    three lie on a diagonal through pixel centres of an ``image_size``
    image, 1e-7.5 to 1e-6.5 of their length off it, where the float edge
    tests accept pixel centres along the line beyond the sliver's box; the
    others are random, 1e-9 to 1e-3 off. Each of the next two
    blocks holds 256 such slivers on one diagonal whose ends are pixel
    centres at the corners of 16 x 16 tiles, so the block's box ends at a
    tile border and any pixel that its faces win beyond it lies in a tile
    that the box misses."""
    S = image_size
    rng = np.random.RandomState(seed + 1000)
    centre = (2.0 * np.arange(S) + 1.0 - S) / S
    fv = np.zeros((768, 3, 3), np.float32)
    fv[:120] = degenerate_faces(seed)
    for i in range(120, 256):
        if i % 3:
            a, b = rng.randint(0, S, 2)
            d = rng.randint(1, max(S // 4, 2))
            c = int(np.clip(b + rng.choice([-1, 1]) * d, 0, S - 1))
            v0 = np.array([centre[a], centre[b]])
            v1 = np.array([centre[min(a + d, S - 1)], centre[c]])
            fv[i, :, :2] = _sliver(rng, v0, v1, -7.5, -6.5)
        else:
            v0 = rng.uniform(-1.0, 1.0, 2)
            v1 = v0 + rng.uniform(-0.5, 0.5, 2)
            fv[i, :, :2] = _sliver(rng, v0, v1, -9.0, -3.0)
    tiles = max(S // 16, 1)
    for k in (1, 2):
        n = rng.randint(1, max(tiles // 2, 1) + 1)     # length in tiles
        tx, ty = rng.randint(0, tiles - n + 1, 2)
        a, b = 16 * tx, 16 * ty
        e = min(16 * n - 1, S - 1 - max(a, b))
        v0, v1 = ((a, b), (a + e, b + e)) if rng.rand() < 0.5 else (
            (a, b + e), (a + e, b))
        v0 = np.array([centre[v0[0]], centre[v0[1]]])
        v1 = np.array([centre[v1[0]], centre[v1[1]]])
        for i in range(256 * k, 256 * (k + 1)):
            fv[i, :, :2] = _sliver(rng, v0, v1, -7.5, -6.5)
    fv[120:, :, 2] = rng.uniform(0.5, 1.0, (len(fv) - 120, 3))
    return fv
