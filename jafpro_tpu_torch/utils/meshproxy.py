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
