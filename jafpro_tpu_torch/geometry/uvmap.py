"""Mesh / UV asset utilities (port of ``jafpro_tpu/geometry/uvmap.py``).

The host-side NumPy code is the port's own copy of the JAX package's
(the port imports nothing of it); ``fit_uv_image`` runs in PyTorch.
Re-design of reference ``src/mesh.py``: OBJ loading, face->UV-vertex tables
(``get_f2vts``), per-face attribute mappings (``create_mapping``: uv / seg /
uv_seg / par / front / head / back / ids / binary), and per-face UV samplers
(``create_uvsampler``).  These feed the full-capability SMPL renderer
(texture extraction / fim encoding); the core flow path needs none of them.

Assets: an OBJ-format UV mapping (``mapper.txt``), ``smpl_part_info.json``,
``front_facial.json``, ``head.json`` — found by ``default_asset`` or passed
explicitly.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.ops.sampling import grid_sample


def load_obj(path: str) -> Dict[str, np.ndarray]:
    verts, vts, vns = [], [], []
    faces, faces_vts, faces_vns = [], [], []
    with open(path) as fp:
        for line in fp:
            s = line.rstrip().split()
            if not s:
                continue
            if s[0] == "v":
                verts.append([float(x) for x in s[1:4]])
            elif s[0] == "vt":
                vts.append([float(x) for x in s[1:3]])
            elif s[0] == "vn":
                vns.append([float(x) for x in s[1:4]])
            elif s[0] == "f":
                f, fvt, fvn = [], [], []
                for p in s[1:4]:
                    q = p.split("/")
                    f.append(int(q[0]) - 1)
                    if len(q) > 1 and q[1]:
                        fvt.append(int(q[1]) - 1)
                    if len(q) > 2 and q[2]:
                        fvn.append(int(q[2]) - 1)
                faces.append(f)
                if fvt:
                    faces_vts.append(fvt)
                if fvn:
                    faces_vns.append(fvn)
    return {
        "verts": np.asarray(verts, np.float32),
        "vts": np.asarray(vts, np.float32),
        "vns": np.asarray(vns, np.float32) if vns else np.zeros((0, 3)),
        "faces": np.asarray(faces, np.int32),
        "faces_vts": np.asarray(faces_vts, np.int32),
        "faces_vns": np.asarray(faces_vns, np.int32) if faces_vns
        else np.zeros((0, 3), np.int32),
    }


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fp:
        fp.write("g\n")
        for v in verts:
            fp.write("v %f %f %f\n" % (v[0], v[1], v[2]))
        for f in np.asarray(faces) + 1:
            fp.write("f %d %d %d\n" % (f[0], f[1], f[2]))
        fp.write("s off\n")


def get_f2vts(uv_mapping_path: str, fill_back: bool = False) -> np.ndarray:
    """Face -> UV-vertex coords (F, 3, 3), with v flipped (1 - v) and a zero
    z column (reference ``mesh.py:173-196``)."""
    info = load_obj(uv_mapping_path)
    vts = info["vts"].copy()
    vts[:, 1] = 1.0 - vts[:, 1]
    vts = np.concatenate(
        [vts, np.zeros((vts.shape[0], 1), np.float32)], axis=-1)
    faces = info["faces_vts"]
    if fill_back:
        faces = np.concatenate([faces, faces[:, ::-1]], axis=0)
    return vts[faces]


def compute_barycenter(f2vts: np.ndarray) -> np.ndarray:
    v2 = f2vts[:, 2]
    return v2 + 0.5 * (f2vts[:, 0] - v2) + 0.5 * (f2vts[:, 1] - v2)


def _face_set_mapping(nf, ids, fill_back=False):
    if fill_back:
        ids = list(ids) + [i + nf // 2 for i in ids]
    m = np.zeros((nf, 1), np.float32)
    m[np.asarray(list(ids), np.int64)] = 1.0
    return m, np.array([[0.0]], np.float32)


def create_mapping(
    map_name: str,
    mapping_path: str,
    part_info: Optional[str] = None,
    front_info: Optional[str] = None,
    head_info: Optional[str] = None,
    contain_bg: bool = True,
    fill_back: bool = False,
) -> np.ndarray:
    """Per-face attribute table indexed by face id, last row = background
    (reference ``mesh.py:368-423``).  Used by ``encode_fim``:
    ``map_fn[fim]`` paints each pixel with its face's attribute."""
    f2vts = get_f2vts(mapping_path, fill_back=fill_back)
    nf = f2vts.shape[0]

    if map_name == "uv":
        map_fn = compute_barycenter(f2vts)[:, 0:2]
        bg = np.array([[-1.0, -1.0]], np.float32)
    elif map_name == "seg":
        map_fn = np.ones((nf, 1), np.float32)
        bg = np.array([[0.0]], np.float32)
    elif map_name == "uv_seg":
        map_fn = compute_barycenter(f2vts)
        bg = np.array([[0.0, 0.0, 1.0]], np.float32)
    elif map_name == "ids":
        map_fn = np.arange(nf, dtype=np.float32)[:, None]
        bg = np.array([[-1.0]], np.float32)
    elif map_name == "binary":
        nbits = int(np.ceil(np.log2(max(nf, 2))))
        ids = np.arange(nf, dtype=np.int64)
        map_fn = ((ids[:, None] >> np.arange(nbits - 1, -1, -1)) & 1
                  ).astype(np.float32)
        bg = -np.ones((1, nbits), np.float32)
    elif map_name == "par":
        with open(part_info) as f:
            parts = json.load(f)
        n_parts = len(parts)
        map_fn = np.zeros((nf, n_parts + 1), np.float32)
        for k, (name, rng) in enumerate(sorted(parts.items())):
            ids = np.asarray(rng, np.int64)
            if ids.size == 2 and ids[1] > ids[0] + 1:
                map_fn[ids[0]:ids[1], k] = 1.0
            else:
                map_fn[ids, k] = 1.0
        bg = np.zeros((1, n_parts + 1), np.float32)
        bg[0, -1] = 1.0
    elif map_name in ("front", "head"):
        info = front_info if map_name == "front" else head_info
        with open(info) as f:
            ids = json.load(f)["face"]
        map_fn, bg = _face_set_mapping(nf, ids, fill_back)
    elif map_name == "back":
        with open(head_info) as f:
            head = set(json.load(f)["face"])
        with open(front_info) as f:
            front = set(json.load(f)["face"])
        map_fn, bg = _face_set_mapping(nf, head - front, fill_back)
    else:
        raise ValueError(f"map name error {map_name}")

    if contain_bg:
        map_fn = np.concatenate([map_fn, bg], axis=0)
    return map_fn


def create_uvsampler(uv_mapping_path: str, tex_size: int = 3) -> np.ndarray:
    """Static per-face UV sample grids (F, T*T, 2) in [-1, 1] grid_sample
    coords (reference ``mesh.py:530-560``)."""
    alpha = np.arange(tex_size, dtype=np.float32) / (tex_size - 1)
    coords = np.stack(
        [p for p in itertools.product(alpha, alpha)])  # (T*T, 2)

    f2vts = get_f2vts(uv_mapping_path)[:, :, :2]
    v2 = f2vts[:, 2]
    v0v2 = f2vts[:, 0] - v2
    v1v2 = f2vts[:, 1] - v2
    # (F, 2, T*T)
    samples = np.dstack([v0v2, v1v2]) @ coords.T + v2[:, :, None]
    samples = np.clip(samples, 0.0, 1.0)
    samples = samples.transpose(0, 2, 1)  # (F, T*T, 2) in [0, 1]
    return samples * 2.0 - 1.0


def default_asset(name: str) -> Optional[str]:
    """``name`` under ``$JAFPRO_ASSETS`` or the package's ``assets/``;
    None when absent (the repository ships none of these assets)."""
    for base in (os.environ.get("JAFPRO_ASSETS", ""),
                 os.path.join(os.path.dirname(os.path.dirname(
                     os.path.abspath(__file__))), "assets")):
        if base:
            p = os.path.join(base, name)
            if os.path.exists(p):
                return p
    return None


def fit_uv_image(uv_sampler, texture, uv_size: int = 224,
                 steps: int = 2000, lr: float = 1e-2,
                 device="cuda") -> torch.Tensor:
    """Recover a UV-space image whose per-face samples match ``texture``
    (the reference's ``UVImageModel`` / ``compute_uv_image``,
    ``src/mesh.py:608-657``): Adam on a (uv_size, uv_size, 3) latent, with
    optax's defaults (which are ``torch.optim.Adam``'s), from ``-1``
    everywhere, so that grid-sampling ``tanh`` of it at the per-face UV
    coords reproduces the per-face texture. Deterministic: no random draw.

    Args:
      uv_sampler: (F, T*T, 2) [-1, 1] sample coords (``create_uvsampler``).
      texture:    (F, T, T, 3) target per-face texture in (-1, 1).
    Returns:
      (uv_size, uv_size, 3) float32 image in (-1, 1) on ``device``.
    """
    dev = resolve_device(device)
    F, TT, _ = uv_sampler.shape
    tgt = torch.as_tensor(np.asarray(texture, np.float32), device=dev
                          ).reshape(1, F, TT, 3).permute(0, 3, 1, 2)
    grid = torch.as_tensor(np.asarray(uv_sampler, np.float32),
                           device=dev)[None]                # (1, F, T*T, 2)
    w = torch.full((1, 3, uv_size, uv_size), -1.0, device=dev,
                   requires_grad=True)
    opt = torch.optim.Adam([w], lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(torch.square(grid_sample(torch.tanh(w), grid)
                                       - tgt))
        loss.backward()
        opt.step()
    return torch.tanh(w.detach())[0].permute(1, 2, 0)
