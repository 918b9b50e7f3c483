"""Face-index + barycentric-weight rasterizer (the z-buffer kernel).

``rasterize_fim_wim`` is the port of the Pallas TPU kernel
``jafpro_tpu/geometry/rasterizer_pallas.py::rasterize_fim_wim_pallas``: for a
CUDA tensor it launches the hand-written kernel in ``csrc/rasterizer.cu``
(built with ``nvcc`` at first use, bound with ``ctypes``) or raises; for a
CPU tensor it takes ``rasterize_fim_wim_reference``, the plain PyTorch
version, which is also the yardstick the kernel is checked against on the
card.

Contract (the Pallas kernel's, and ``rasterize_fim_wim(depth_mode="exact")``
of the JAX package): (B, F, 3, 3) view-space triangles -> face-index map
``fim`` (B, S, S) int32 with -1 for background and weight map ``wim``
(B, S, S, 3), y-flipped with ``flip_y``; the nearest front face wins, ties
go to the lowest face id.

Both versions start from the same per-face prep (``prepare_faces``) and
evaluate every per-(pixel, face) expression in the Pallas kernel's order,
so on the card their face ids agree bit for bit. The kernel skips face
blocks whose front-face bounding box holds no pixel centre of its tile;
the plain version tests every face.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

FACE_BLOCK = 256  # faces per shared-memory block in the kernel
NF = 19           # floats per face record (csrc/rasterizer.cu)


class PreparedFaces(NamedTuple):
    faces: torch.Tensor   # (B, NF, F_pad): x0..2, y0..2, z0..2, inv[9], valid
    extent: torch.Tensor  # (B, n_blocks, 4): front-face ymin, ymax, xmin, xmax


def prepare_faces(face_verts: torch.Tensor, image_size: int) -> PreparedFaces:
    """Per-face prep shared by the kernel and the plain version
    (``rasterizer_pallas.py:141-174``): back-face flag, the inverse matrix
    of the pixel-space triangle divided by its determinant, padding to
    whole blocks, and per-block front-face bounding boxes."""
    S = image_size
    B, F = face_verts.shape[:2]
    fv = face_verts.float()
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]  # (B, F, 3)
    front = (y[..., 2] - y[..., 0]) * (x[..., 1] - x[..., 0]) >= (
        (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))

    p = 0.5 * (fv[..., :2] * S + S - 1)  # (B, F, 3, 2) pixel coords
    p0x, p0y = p[..., 0, 0], p[..., 0, 1]
    p1x, p1y = p[..., 1, 0], p[..., 1, 1]
    p2x, p2y = p[..., 2, 0], p[..., 2, 1]
    inv = torch.stack([
        p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y,
        p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y,
        p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y,
    ], dim=-1)  # (B, F, 9)
    denom = (p2x * (p0y - p1y) + p0x * (p1y - p2y) + p1x * (p2y - p0y))
    inv = inv / denom[..., None]

    n_blocks = -(-F // FACE_BLOCK)
    pad = n_blocks * FACE_BLOCK - F
    rec = torch.cat([x, y, z, inv, front.float()[..., None]], dim=-1)
    if pad:
        filler = torch.zeros(B, pad, NF, dtype=rec.dtype, device=rec.device)
        filler[..., 3:6] = 1e9   # y far away, as the Pallas padding
        filler[..., 6:9] = 1.0   # z
        rec = torch.cat([rec, filler], dim=1)
        front = torch.cat([front, torch.zeros(
            B, pad, dtype=torch.bool, device=front.device)], dim=1)
    ry = rec[..., 3:6]
    rx = rec[..., 0:3]
    inf = torch.tensor(float("inf"), device=rec.device)
    ext = torch.stack([
        torch.where(front, ry.amin(-1), inf),
        torch.where(front, ry.amax(-1), -inf),
        torch.where(front, rx.amin(-1), inf),
        torch.where(front, rx.amax(-1), -inf),
    ], dim=-1).reshape(B, n_blocks, FACE_BLOCK, 4)
    extent = torch.stack([
        ext[..., 0].amin(-1), ext[..., 1].amax(-1),
        ext[..., 2].amin(-1), ext[..., 3].amax(-1)], dim=-1)
    return PreparedFaces(rec.transpose(1, 2).contiguous(),
                         extent.contiguous())


def _winner_weights(inv: torch.Tensor, idx: torch.Tensor, xi: torch.Tensor,
                    yi: torch.Tensor) -> torch.Tensor:
    """Recompute the winning face's weights (``rasterizer_pallas.py:204-221``).
    inv: (F_pad, 9); idx: (P,) int64, -1 = background; xi, yi: (P,)."""
    found = idx >= 0
    iw = inv[idx.clamp(min=0)]  # (P, 9)
    w0 = iw[:, 0] * xi + iw[:, 1] * yi + iw[:, 2]
    w1 = iw[:, 3] * xi + iw[:, 4] * yi + iw[:, 5]
    w2 = iw[:, 6] * xi + iw[:, 7] * yi + iw[:, 8]
    w0, w1, w2 = (torch.clamp(w, 0.0, 1.0) for w in (w0, w1, w2))
    ws = w0 + w1 + w2
    w = torch.stack([w0 / ws, w1 / ws, w2 / ws], dim=-1)
    return torch.where(found[:, None], w, torch.zeros_like(w))


def rasterize_prepared_reference(
    prep: PreparedFaces, image_size: int, near: float, far: float,
    flip_y: bool = True,
) -> tuple:
    """Plain PyTorch z-buffer over prepared faces: dense over every face,
    as many faces at a time as keep a (pixels x faces) temporary near 16M
    elements, per-(pixel, face) arithmetic as the Pallas kernel's.
    Returns (fim (B,S,S) int32, wim (B,S,S,3))."""
    S = image_size
    faces = prep.faces
    B, _, F_pad = faces.shape
    dev = faces.device
    P = S * S
    pix = torch.arange(P, device=dev)
    yi = (pix // S).float()
    xi = (pix % S).float()
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the IEEE quotient the kernel computes
    s_t = torch.tensor(float(S), device=dev)
    xp = ((2.0 * xi + 1.0 - S) / s_t)[:, None]
    yp = ((2.0 * yi + 1.0 - S) / s_t)[:, None]
    xic, yic = xi[:, None], yi[:, None]
    K = max(1, min(F_pad, (1 << 24) // P))
    far_t = torch.tensor(far, dtype=torch.float32, device=dev)

    fims, wims = [], []
    for b in range(B):
        rec = faces[b]  # (NF, F_pad)
        best = torch.full((P,), far, dtype=torch.float32, device=dev)
        best_id = torch.full((P,), -1, dtype=torch.int64, device=dev)
        for c0 in range(0, F_pad, K):
            r = rec[:, c0:c0 + K, None].unbind(0)  # NF x (K, 1)
            x0, x1, x2, y0, y1, y2, z0, z1, z2 = (t.T for t in r[:9])
            inv = [t.T for t in r[9:18]]
            val = r[18].T > 0
            e0 = (yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0)
            e1 = (yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1)
            e2 = (yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2)
            inside = e0 & e1 & e2 & val
            w0 = inv[0] * xic + inv[1] * yic + inv[2]
            w1 = inv[3] * xic + inv[4] * yic + inv[5]
            w2 = inv[6] * xic + inv[7] * yic + inv[8]
            w0 = torch.clamp(w0, 0.0, 1.0)
            w1 = torch.clamp(w1, 0.0, 1.0)
            w2 = torch.clamp(w2, 0.0, 1.0)
            ws = w0 + w1 + w2
            inv_zp = (w0 / z0 + w1 / z1 + w2 / z2) / ws
            zp = 1.0 / inv_zp
            ok = inside & (zp > near) & (zp < far) & (inv_zp > 0)
            depth = torch.where(ok, zp, far_t)        # (P, K)
            arg = torch.argmin(depth, dim=1)          # first minimum
            kmin = torch.gather(depth, 1, arg[:, None])[:, 0]
            better = kmin < best
            best = torch.where(better, kmin, best)
            best_id = torch.where(better, c0 + arg, best_id)
        inv_all = rec[9:18].T  # (F_pad, 9)
        w = _winner_weights(inv_all, best_id, xi, yi)
        fims.append(best_id.to(torch.int32).reshape(S, S))
        wims.append(w.reshape(S, S, 3))
    fim = torch.stack(fims)
    wim = torch.stack(wims)
    if flip_y:
        fim = torch.flip(fim, dims=[1])
        wim = torch.flip(wim, dims=[1])
    return fim, wim


def _check_face_verts(face_verts: torch.Tensor) -> None:
    if not isinstance(face_verts, torch.Tensor):
        raise TypeError("face_verts must be a torch.Tensor")
    if face_verts.dtype != torch.float32:
        raise TypeError(f"face_verts must be float32, got {face_verts.dtype}")
    if face_verts.ndim != 4 or face_verts.shape[2:] != (3, 3):
        raise ValueError(
            f"face_verts must be (B, F, 3, 3), got {tuple(face_verts.shape)}")
    if face_verts.shape[1] == 0:
        raise ValueError("face_verts holds no faces")


def rasterize_fim_wim_reference(
    face_verts: torch.Tensor, image_size: int = 256, near: float = 0.1,
    far: float = 25.0, flip_y: bool = True,
) -> tuple:
    """Plain PyTorch version of ``rasterize_fim_wim`` on any device."""
    _check_face_verts(face_verts)
    prep = prepare_faces(face_verts, image_size)
    return rasterize_prepared_reference(prep, image_size, near, far, flip_y)


def _kernel_library():
    from jafpro_tpu_torch import cuda_build

    lib = cuda_build.load("rasterizer.cu")
    fn = lib.jafpro_rasterize_fim_wim
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, ci, ci, ci, ci, cf, cf, ci, vp, vp, vp]
        fn.restype = ci
    return fn


def rasterize_prepared_cuda(prep: PreparedFaces, image_size: int,
                            near: float, far: float,
                            flip_y: bool = True) -> tuple:
    """Launch the CUDA kernel on prepared faces (CUDA tensors only)."""
    faces, extent = prep.faces, prep.extent
    for name, t in (("faces", faces), ("extent", extent)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or (
                not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
    B, nf, F_pad = faces.shape
    if nf != NF or F_pad % FACE_BLOCK or extent.shape != (
            B, F_pad // FACE_BLOCK, 4) or extent.device != faces.device:
        raise ValueError("prepared faces do not match the kernel's layout")
    S = image_size
    fim = torch.empty((B, S, S), dtype=torch.int32, device=faces.device)
    wim = torch.empty((B, S, S, 3), dtype=torch.float32, device=faces.device)
    fn = _kernel_library()
    with torch.cuda.device(faces.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(faces.data_ptr(), extent.data_ptr(), B, F_pad,
                F_pad // FACE_BLOCK, S, near, far, int(flip_y),
                fim.data_ptr(), wim.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: CUDA error {rc}")
    rasterize_fim_wim.launches += 1
    return fim, wim


def rasterize_fim_wim(
    face_verts: torch.Tensor, image_size: int = 256, near: float = 0.1,
    far: float = 25.0, flip_y: bool = True,
) -> tuple:
    """(B, F, 3, 3) float32 view-space triangles ->
    (fim (B, S, S) int32, wim (B, S, S, 3) float32).

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through ``rasterize_fim_wim_reference``. ``rasterize_fim_wim.launches``
    counts kernel launches."""
    _check_face_verts(face_verts)
    if face_verts.device.type == "cpu":
        return rasterize_fim_wim_reference(face_verts, image_size, near, far,
                                           flip_y)
    if face_verts.device.type != "cuda":
        raise ValueError(f"unsupported device {face_verts.device}")
    prep = prepare_faces(face_verts, image_size)
    return rasterize_prepared_cuda(prep, image_size, near, far, flip_y)


rasterize_fim_wim.launches = 0
