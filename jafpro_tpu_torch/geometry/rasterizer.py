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
``fim`` (B, S, S) int32 with -1 for background, weight map ``wim``
(B, S, S, 3) and, with ``return_depth``, depth map ``dim`` (B, S, S): the
winner's perspective-correct depth, 0 at background; all y-flipped with
``flip_y``. The nearest front face wins, ties go to the lowest face id.

Gradients: the kernel has none. When the triangles require a gradient,
``wim`` and ``dim`` carry the JAX package's (``rasterizer.py:536-549``):
differentiable in the vertices for a fixed winner. Their forward values
stay the kernel's; the backward recomputes them from the triangles for
the kernel's ``fim`` (``winner_weights_depth``).

Both versions start from the same per-face prep (``prepare_faces``) and
evaluate every per-(pixel, face) expression in the Pallas kernel's order,
so on the card their face ids agree bit for bit. The kernel skips face
blocks whose cull box holds no pixel centre of its tile and then culls the
faces of a block one by one (``face_tile_keep`` is the plain form of both
culls); the plain version tests every face.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from jafpro_tpu_torch.utils.profiling import span

FACE_BLOCK = 256  # faces per shared-memory block in the kernel
NF = 19           # floats per face record (csrc/rasterizer.cu)


class PreparedFaces(NamedTuple):
    faces: torch.Tensor   # (B, NF, F_pad): x0..2, y0..2, z0..2, inv[9], valid
    extent: torch.Tensor  # (B, n_blocks, 4): cull box ymin, ymax, xmin, xmax


TILE = 16                  # pixels per side of the kernel's tile (one CTA)
REACH = 2.0 ** -18         # 32 float32 epsilons: the cull's reach factor


def face_cull_box(x: torch.Tensor, y: torch.Tensor, image_size: int) -> tuple:
    """The box outside which a face's float edge tests accept no pixel
    centre: the kernel's per-face cull (``keep_face`` in
    ``csrc/rasterizer.cu``), value for value. x, y: (..., 3)
    clip-space vertex coords. Returns (xlo, xhi, ylo, yhi).

    In float the edge tests accept a point outside the exact triangle only
    within 2*err*W / (2A) of the triangle's box, where err <= ~6 eps (1 + M)
    W is their rounding error (M the largest |coordinate|, W the larger side
    of the box) and 2A the doubled area (|a - b|, the two products of the
    front test), so within 12 eps (1 + M) W^2 / (2A). The box is widened by
    one pixel (2/S) plus r = REACH (1 + M) W^2 / |a - b|, 8/3 of that. A
    face with r > 4 (wider than the clip square: slivers whose area is
    rounding error, zero-area faces, which the edge tests accept all along
    their line, and a NaN) gets an unbounded box."""
    S = image_size
    # 2/S as the kernel's float32 quotient, as a Python scalar: a scalar
    # tensor made on the card would cost a blocking host-to-device copy
    m = float(torch.tensor(2.0) / torch.tensor(float(S)))
    # the kernel's values in fewer launches (min, max and negation are
    # exact; prepare_faces runs this on the main path)
    xmin, xmax = torch.aminmax(x, dim=-1)
    ymin, ymax = torch.aminmax(y, dim=-1)
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    a = (y2 - y0) * (x1 - x0)
    b = (y1 - y0) * (x2 - x0)
    M = torch.maximum(torch.maximum(-xmin, xmax), torch.maximum(-ymin, ymax))
    W = torch.maximum(xmax - xmin, ymax - ymin)
    r = REACH * (1.0 + M) * W * W / (a - b).abs()
    w = torch.where(r <= 4.0, m + r, float("inf"))
    return xmin - w, xmax + w, ymin - w, ymax + w


def prepare_faces(face_verts: torch.Tensor, image_size: int) -> PreparedFaces:
    """Per-face prep shared by the kernel and the plain version
    (``rasterizer_pallas.py:141-174``): back-face flag, the inverse matrix
    of the pixel-space triangle divided by its determinant, padding to
    whole blocks, and per-block cull boxes for the kernel's block skip.

    A block's cull box holds the ``face_cull_box`` of each of its front
    faces: the Pallas kernel's block box (the faces' exact boxes) can miss
    pixels that a sliver's float edge tests accept beyond its box."""
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
    xlo, xhi, ylo, yhi = face_cull_box(rec[..., 0:3], rec[..., 3:6], S)
    inf = float("inf")
    ext = torch.stack([
        torch.where(front, ylo, inf), torch.where(front, yhi, -inf),
        torch.where(front, xlo, inf), torch.where(front, xhi, -inf),
    ], dim=-1).reshape(B, n_blocks, FACE_BLOCK, 4)
    extent = torch.stack([
        ext[..., 0].amin(-1), ext[..., 1].amax(-1),
        ext[..., 2].amin(-1), ext[..., 3].amax(-1)], dim=-1)
    return PreparedFaces(rec.transpose(1, 2).contiguous(),
                         extent.contiguous())


def face_tile_keep(prep: PreparedFaces, image_size: int) -> torch.Tensor:
    """The faces the kernel tests in each ``TILE`` x ``TILE`` pixel tile:
    (B, n_tiles_y, n_tiles_x, F_pad) bool, tiles in unflipped row order.

    Plain form of the kernel's two culls (``csrc/rasterizer.cu``,
    ``next_block`` and ``keep_face``): a face is tested if its block's cull
    box (``prep.extent``) holds a pixel centre of the tile, and the face is
    valid and its ``face_cull_box`` holds one too."""
    S = image_size
    faces, extent = prep.faces, prep.extent
    dev = faces.device
    s_t = torch.tensor(float(S), device=dev)
    lo = torch.arange(0, S, TILE, device=dev)
    hi = torch.clamp(lo + TILE - 1, max=S - 1)
    c_lo = ((2.0 * lo.float() + 1.0 - S) / s_t)[None, :, None]   # (1, T, 1)
    c_hi = ((2.0 * hi.float() + 1.0 - S) / s_t)[None, :, None]

    # next_block: the block's cull box [ymin, ymax, xmin, xmax]
    e = extent[:, None]                                           # (B,1,nb,4)
    blk_y = (e[..., 1] >= c_lo) & (e[..., 0] <= c_hi)             # (B,T,nb)
    blk_x = (e[..., 3] >= c_lo) & (e[..., 2] <= c_hi)
    blk = blk_y[:, :, None] & blk_x[:, None, :]                   # (B,Ty,Tx,nb)
    blk = blk.repeat_interleave(FACE_BLOCK, dim=-1)

    # keep_face
    xlo, xhi, ylo, yhi = (t[:, None] for t in face_cull_box(
        faces[:, 0:3].transpose(1, 2), faces[:, 3:6].transpose(1, 2), S))
    valid = faces[:, 18, None] > 0                                # (B,1,F)
    hit_x = (xhi >= c_lo) & (xlo <= c_hi)                         # (B,T,F)
    hit_y = (yhi >= c_lo) & (ylo <= c_hi)
    hit = hit_y[:, :, None] & hit_x[:, None, :]                   # (B,Ty,Tx,F)
    return blk & valid[:, None] & hit


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
    flip_y: bool = True, return_depth: bool = False,
) -> tuple:
    """Plain PyTorch z-buffer over prepared faces: dense over every face,
    as many faces at a time as keep a (pixels x faces) temporary near 16M
    elements, per-(pixel, face) arithmetic as the Pallas kernel's.
    Returns (fim (B,S,S) int32, wim (B,S,S,3)[, dim (B,S,S)]); ``dim`` is
    the winner's depth (the running minimum), 0 at background."""
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

    fims, wims, dims = [], [], []
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
        dims.append(torch.where(best_id >= 0, best, 0.0).reshape(S, S))
    out = [torch.stack(fims), torch.stack(wims)]
    if return_depth:
        out.append(torch.stack(dims))
    if flip_y:
        out = [torch.flip(t, dims=[1]) for t in out]
    return tuple(out)


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
    far: float = 25.0, flip_y: bool = True, return_depth: bool = False,
) -> tuple:
    """Plain PyTorch version of ``rasterize_fim_wim`` on any device."""
    _check_face_verts(face_verts)
    prep = prepare_faces(face_verts, image_size)
    return rasterize_prepared_reference(prep, image_size, near, far, flip_y,
                                        return_depth)


def _kernel_library():
    from jafpro_tpu_torch import cuda_build

    lib = cuda_build.load("rasterizer.cu")
    fn = lib.jafpro_rasterize_fim_wim
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, ci, ci, ci, ci, cf, cf, ci, vp, vp, vp, vp]
        fn.restype = ci
    return fn


def rasterize_prepared_cuda(prep: PreparedFaces, image_size: int,
                            near: float, far: float, flip_y: bool = True,
                            return_depth: bool = False) -> tuple:
    """Launch the CUDA kernel on prepared faces (CUDA tensors only).
    Returns (fim, wim[, dim]); without ``return_depth`` the kernel gets a
    null depth pointer and writes no depth."""
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
    dim = (torch.empty((B, S, S), dtype=torch.float32, device=faces.device)
           if return_depth else None)
    fn = _kernel_library()
    with torch.cuda.device(faces.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(faces.data_ptr(), extent.data_ptr(), B, F_pad,
                F_pad // FACE_BLOCK, S, near, far, int(flip_y),
                fim.data_ptr(), wim.data_ptr(),
                None if dim is None else dim.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: CUDA error {rc}")
    rasterize_fim_wim.launches += 1
    return (fim, wim) if dim is None else (fim, wim, dim)


def winner_weights_depth(face_verts: torch.Tensor, fim: torch.Tensor,
                         image_size: int, flip_y: bool = True) -> tuple:
    """The winner's weights and depth recomputed from its triangle, in
    differentiable PyTorch ops: (wim (B,S,S,3), dim (B,S,S)), zero at
    background. ``fim`` is a rasterizer output in the same ``flip_y``
    orientation. Weights as the kernel's epilogue (``prepare_faces``'
    inverse matrix, clamp, renormalise); depth in the JAX package's exact
    order, ``1 / (sum_k w_k / z_k)`` as ``(sum_k w_k * (1 / z_k)) / ws``
    over the clamped weights (``rasterizer.py:160-167``, ``:533``)."""
    S = image_size
    B = fim.shape[0]
    found = fim >= 0
    bidx = torch.arange(B, device=fim.device).view(B, 1, 1)
    fv = face_verts[bidx, fim.clamp(min=0).long()]          # (B,S,S,3,3)
    p = 0.5 * (fv[..., :2] * S + S - 1)
    p0x, p0y = p[..., 0, 0], p[..., 0, 1]
    p1x, p1y = p[..., 1, 0], p[..., 1, 1]
    p2x, p2y = p[..., 2, 0], p[..., 2, 1]
    denom = (p2x * (p0y - p1y) + p0x * (p1y - p2y) + p1x * (p2y - p0y))
    rows = torch.arange(S, device=fim.device, dtype=torch.float32)
    yi = (S - 1 - rows if flip_y else rows)[:, None]
    xi = rows[None, :]

    def weight(a, b, c):
        return torch.clamp((a / denom) * xi + (b / denom) * yi + c / denom,
                           0.0, 1.0)

    w0 = weight(p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y)
    w1 = weight(p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y)
    w2 = weight(p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y)
    ws = w0 + w1 + w2
    wim = torch.stack([w0 / ws, w1 / ws, w2 / ws], dim=-1)
    iz = 1.0 / fv[..., 2]
    q = (w0 * iz[..., 0] + w1 * iz[..., 1] + w2 * iz[..., 2]) / ws
    dim = 1.0 / torch.clamp(q, min=1e-20)
    zero = torch.zeros((), dtype=wim.dtype, device=wim.device)
    return (torch.where(found[..., None], wim, zero),
            torch.where(found, dim, zero))


class _WinnerGrad(torch.autograd.Function):
    """Forward: the rasterizer's own wim (and dim, when given). Backward: the
    vector-Jacobian product of ``winner_weights_depth`` for the fixed
    ``fim``, over the outputs that received a gradient."""

    @staticmethod
    def forward(ctx, face_verts, fim, image_size, flip_y, wim, dim):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(face_verts, fim)
        ctx.image_size, ctx.flip_y = image_size, flip_y
        return wim if dim is None else (wim, dim)

    @staticmethod
    def backward(ctx, *grads):
        face_verts, fim = ctx.saved_tensors
        g_fv = None
        with torch.enable_grad():
            fv = face_verts.detach().requires_grad_()
            outs = winner_weights_depth(fv, fim, ctx.image_size, ctx.flip_y)
            pairs = [(t, g) for t, g in zip(outs, grads) if g is not None]
            if pairs:
                (g_fv,) = torch.autograd.grad([t for t, _ in pairs], fv,
                                              [g for _, g in pairs])
        return g_fv, None, None, None, None, None


def rasterize_fim_wim(
    face_verts: torch.Tensor, image_size: int = 256, near: float = 0.1,
    far: float = 25.0, flip_y: bool = True, return_depth: bool = False,
) -> tuple:
    """(B, F, 3, 3) float32 view-space triangles ->
    (fim (B, S, S) int32, wim (B, S, S, 3) float32[, dim (B, S, S)]).

    A CUDA tensor goes through the CUDA kernel (or raises); a CPU tensor
    through ``rasterize_prepared_reference``. ``rasterize_fim_wim.launches``
    counts kernel launches. When ``face_verts`` requires a gradient (and
    grad mode is on), ``wim`` and ``dim`` are differentiable in it for the
    fixed face ids (``_WinnerGrad``); otherwise nothing is recomputed."""
    _check_face_verts(face_verts)
    if face_verts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {face_verts.device}")
    with torch.no_grad():
        with span("flow.prepare_faces", device=True):
            prep = prepare_faces(face_verts, image_size)
        run = (rasterize_prepared_reference
               if face_verts.device.type == "cpu" else rasterize_prepared_cuda)
        with span("flow.raster", device=True):
            out = run(prep, image_size, near, far, flip_y, return_depth)
    if not (face_verts.requires_grad and torch.is_grad_enabled()):
        return out
    fim, wim = out[:2]
    dim = out[2] if return_depth else None
    grad = _WinnerGrad.apply(face_verts, fim, image_size, flip_y, wim, dim)
    return (fim, *grad) if return_depth else (fim, grad)


rasterize_fim_wim.launches = 0
