"""The generator's parameter-free operations, plain PyTorch: resizes,
bilinear sampling, the DensePose texture warps, the weak-perspective
projection, a dense z-buffer and the SMPL barycentric flow.

The z-buffer evaluates every (pixel, face) pair with the arithmetic of the
rasterizer's published contract (nearest front face within (near, far),
ties to the lowest face id, weights clamped and renormalised, y flipped), in
the order of operations that a kernel built without fused multiply-adds
follows, so face ids come out as an exact z-buffer's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def avg_pool_3x3s2(x):
    """k 3, s 2, p 1, padding counted; a tensor that needs a gradient is
    made contiguous (CUDA's backward is wrong on channels-last inputs)."""
    if x.requires_grad:
        x = x.contiguous()
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


@functools.lru_cache(maxsize=64)
def interp_matrix(in_size: int, out_size: int,
                  align_corners: bool) -> np.ndarray:
    """(out, in) linear interpolation weights along one axis."""
    w = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        if align_corners:
            w[0, 0] = 1.0
            return w
        src = np.array([0.5 * in_size / out_size - 0.5])
    elif align_corners:
        src = np.linspace(0.0, in_size - 1, out_size)
    else:
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w


def _interp(in_size, out_size, align_corners, device):
    return torch.from_numpy(interp_matrix(in_size, out_size,
                                          align_corners)).to(device)


def resize_bilinear(x, size, align_corners=True):
    """(B, C, H, W) -> (B, C, *size), rows then columns."""
    H, W = x.shape[-2:]
    if (H, W) == tuple(size):
        return x
    wh = _interp(H, size[0], align_corners, x.device)
    ww = _interp(W, size[1], align_corners, x.device)
    return torch.matmul(torch.matmul(wh, x.float()), ww.t())


def _gather_2d(image, yi, xi):
    B, C, H, W = image.shape
    idx = (yi * W + xi).reshape(B, 1, -1).expand(B, C, -1)
    return torch.gather(image.reshape(B, C, H * W), 2, idx).reshape(
        B, C, *yi.shape[1:])


def grid_sample(image, grid, padding_mode="border", mode="bilinear",
                pixel_coords=False):
    """``grid_sample`` with align_corners=True on (B, C, H, W) at
    (B, Hg, Wg, 2) (x, y); border padding clamps the corner indices."""
    B, C, H, W = image.shape
    if pixel_coords:
        x, y = grid[..., 0], grid[..., 1]
    else:
        x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
        y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    if mode == "nearest":
        xi = torch.floor(x + 0.5).long()
        yi = torch.floor(y + 0.5).long()
        return _gather_2d(image, yi.clamp(0, H - 1), xi.clamp(0, W - 1))
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def corner(yi, xi, w):
        v = _gather_2d(image, yi.clamp(0, H - 1), xi.clamp(0, W - 1))
        if padding_mode == "zeros":
            w = w * ((xi >= 0) & (xi <= W - 1) & (yi >= 0)
                     & (yi <= H - 1)).to(image.dtype)
        return v * w[:, None]

    return (corner(y0i, x0i, (1 - wy) * (1 - wx))
            + corner(y0i, x0i + 1, (1 - wy) * wx)
            + corner(y0i + 1, x0i, wy * (1 - wx))
            + corner(y0i + 1, x0i + 1, wy * wx))


# ---- DensePose texture warps ------------------------------------------

def parts_to_atlas(parts):
    """(B, 24, p, p, C) -> (B, 4p, 6p, C)."""
    B, P, ph, pw, C = parts.shape
    x = parts.reshape(B, 4, P // 4, ph, pw, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, 4 * ph, (P // 4) * pw, C)


def texture_warp_atlas(atlas, iuv255):
    """Bilinear per-part sample of a (B, 4p, 6p, C) atlas at
    x = (255-V)/255*(p-1), y = U/255*(p-1) of each (B, S, S, 3) IUV pixel;
    0 where the part id is 0."""
    Ha, Wa, C = atlas.shape[1:]
    p = Ha // 4
    B = iuv255.shape[0]
    pid, u, v = iuv255[..., 0], iuv255[..., 1], iuv255[..., 2]
    part = torch.clamp(pid.long() - 1, 0, 23)
    row, col = part // 6, part % 6
    x_loc = (((255.0 - v) / 255.0 - 0.5) * 2.0 + 1.0) * 0.5 * (p - 1)
    y_loc = ((u / 255.0 - 0.5) * 2.0 + 1.0) * 0.5 * (p - 1)
    x0, y0 = torch.floor(x_loc), torch.floor(y_loc)
    wx, wy = x_loc - x0, y_loc - y0
    x0i = torch.clamp(x0.long() + col * p, 0, Wa - 1)
    y0i = torch.clamp(y0.long() + row * p, 0, Ha - 1)
    x1i = torch.clamp(x0i + 1, 0, Wa - 1)
    y1i = torch.clamp(y0i + 1, 0, Ha - 1)
    flat = atlas.reshape(atlas.shape[0], Ha * Wa, C)
    b = torch.arange(B, device=atlas.device)[:, None]

    def tap(yi, xi):
        return flat[b, (yi * Wa + xi).reshape(B, -1)].reshape(*yi.shape, C)

    out = (tap(y0i, x0i) * ((1 - wy) * (1 - wx))[..., None]
           + tap(y0i, x1i) * ((1 - wy) * wx)[..., None]
           + tap(y1i, x0i) * (wy * (1 - wx))[..., None]
           + tap(y1i, x1i) * (wy * wx)[..., None])
    return torch.where((pid > 0)[..., None], out, torch.zeros_like(out))


def texture_warp_lattice(parts, iuv255, grid=256):
    """The warp at integer U, V (the serving path's table): for each pixel,
    the bilinear sample of its part's (p, p) tile at rows u*(p-1)/255 and
    columns (255-v)*(p-1)/255, with U and V rounded to the nearest
    integer. parts (n, P, p, p, C), iuv255 (n, T, S, S, 3) ->
    (n, T, S, S, C)."""
    n, P, p = parts.shape[:3]
    wy = _interp(p, grid, True, parts.device)
    wx = torch.flip(wy, dims=[0])
    lut = torch.einsum("up,bkpqc->bkuqc", wy, parts.float())
    lut = torch.einsum("vq,bkuqc->bkuvc", wx, lut)   # (n, P, G, G, C)
    pid = iuv255[..., 0]
    part = torch.clamp(pid.long() - 1, 0, P - 1)
    u = torch.clamp(torch.floor(iuv255[..., 1] + 0.5).long(), 0, grid - 1)
    v = torch.clamp(torch.floor(iuv255[..., 2] + 0.5).long(), 0, grid - 1)
    idx = ((part * grid + u) * grid + v).reshape(n, -1)
    flat = lut.reshape(n, P * grid * grid, -1)
    b = torch.arange(n, device=parts.device)[:, None]
    out = flat[b, idx].reshape(*pid.shape, -1)
    return torch.where((pid > 0)[..., None], out, torch.zeros_like(out))


# ---- projection, z-buffer and flow -------------------------------------

def project_to_view(verts, cam, viewing_angle=30.0):
    """Weak-perspective camera [s, tx, ty], y flipped, minus the eye at
    (0, 0, -(cot(angle) + 1)). (B, V, 3), (B, 3) -> (B, V, 3)."""
    s = cam[:, 0][:, None, None]
    xy = s * (verts[..., :2] + cam[:, 1:3][:, None, :])
    proj = torch.cat([xy[..., :1], xy[..., 1:2] * -1.0, verts[..., 2:3]], -1)
    eye = torch.tensor(
        [0.0, 0.0, -(1.0 / np.tan(np.radians(viewing_angle)) + 1.0)],
        dtype=torch.float32).to(proj.device)
    return proj - eye


def project_faces(cam, verts, faces, viewing_angle=30.0):
    """(B, 3), (B, V, 3), (F, 3) long -> view-space triangles (B, F, 3, 3)."""
    return project_to_view(verts, cam, viewing_angle)[:, faces]


def zbuffer(fv, S, near=0.1, far=25.0, chunk=1 << 24):
    """Nearest front face per pixel centre of (B, F, 3, 3) view-space
    triangles: (fim (B, S, S) long, -1 at background; wim (B, S, S, 3)),
    y-flipped."""
    B, Fn = fv.shape[:2]
    dev = fv.device
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]                 # (B, F, 3)
    front = (y[..., 2] - y[..., 0]) * (x[..., 1] - x[..., 0]) >= (
        (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    p = 0.5 * (fv[..., :2] * S + S - 1)
    p0x, p0y, p1x, p1y = p[..., 0, 0], p[..., 0, 1], p[..., 1, 0], p[..., 1, 1]
    p2x, p2y = p[..., 2, 0], p[..., 2, 1]
    inv = torch.stack([
        p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y,
        p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y,
        p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y], -1)
    inv = inv / (p2x * (p0y - p1y) + p0x * (p1y - p2y)
                 + p1x * (p2y - p0y))[..., None]                  # (B, F, 9)
    P = S * S
    pix = torch.arange(P, device=dev)
    yi, xi = (pix // S).float(), (pix % S).float()
    s_t = torch.tensor(float(S), device=dev)
    xp = ((2.0 * xi + 1.0 - S) / s_t)[:, None]
    yp = ((2.0 * yi + 1.0 - S) / s_t)[:, None]
    xic, yic = xi[:, None], yi[:, None]
    K = max(1, min(Fn, chunk // P))
    far_t = torch.tensor(far, dtype=torch.float32, device=dev)
    fims, wims = [], []
    for b in range(B):
        best = torch.full((P,), far, dtype=torch.float32, device=dev)
        best_id = torch.full((P,), -1, dtype=torch.long, device=dev)
        for c0 in range(0, Fn, K):
            sl = slice(c0, c0 + K)
            x0, x1, x2 = (t[None] for t in x[b, sl].unbind(-1))
            y0, y1, y2 = (t[None] for t in y[b, sl].unbind(-1))
            z0, z1, z2 = (t[None] for t in z[b, sl].unbind(-1))
            iv = [t[None] for t in inv[b, sl].unbind(-1)]
            e0 = (yp - y0) * (x1 - x0) >= (xp - x0) * (y1 - y0)
            e1 = (yp - y1) * (x2 - x1) >= (xp - x1) * (y2 - y1)
            e2 = (yp - y2) * (x0 - x2) >= (xp - x2) * (y0 - y2)
            inside = e0 & e1 & e2 & front[b, sl][None]
            w0 = torch.clamp(iv[0] * xic + iv[1] * yic + iv[2], 0.0, 1.0)
            w1 = torch.clamp(iv[3] * xic + iv[4] * yic + iv[5], 0.0, 1.0)
            w2 = torch.clamp(iv[6] * xic + iv[7] * yic + iv[8], 0.0, 1.0)
            ws = w0 + w1 + w2
            inv_zp = (w0 / z0 + w1 / z1 + w2 / z2) / ws
            zp = 1.0 / inv_zp
            ok = inside & (zp > near) & (zp < far) & (inv_zp > 0)
            depth = torch.where(ok, zp, far_t)
            arg = torch.argmin(depth, dim=1)
            kmin = torch.gather(depth, 1, arg[:, None])[:, 0]
            better = kmin < best
            best = torch.where(better, kmin, best)
            best_id = torch.where(better, c0 + arg, best_id)
        iw = inv[b][best_id.clamp(min=0)]
        w0 = torch.clamp(iw[:, 0] * xi + iw[:, 1] * yi + iw[:, 2], 0.0, 1.0)
        w1 = torch.clamp(iw[:, 3] * xi + iw[:, 4] * yi + iw[:, 5], 0.0, 1.0)
        w2 = torch.clamp(iw[:, 6] * xi + iw[:, 7] * yi + iw[:, 8], 0.0, 1.0)
        ws = w0 + w1 + w2
        w = torch.stack([w0 / ws, w1 / ws, w2 / ws], -1)
        w = torch.where((best_id >= 0)[:, None], w, torch.zeros_like(w))
        fims.append(best_id.reshape(S, S))
        wims.append(w.reshape(S, S, 3))
    return (torch.flip(torch.stack(fims), dims=[1]),
            torch.flip(torch.stack(wims), dims=[1]))


def barycentric_grid(src_f2pts, fim, wim):
    """(B, F, 3, 2) source xy of each face's vertices, target (B, S, S)
    face ids and weights -> (B, S, S, 2) sampling grid; -2 at background."""
    B = fim.shape[0]
    exist = fim >= 0
    g = src_f2pts[torch.arange(B, device=fim.device).view(B, 1, 1),
                  fim.clamp(min=0)]                               # (B,S,S,3,2)
    w = wim[..., None]
    t = g[..., 0, :] * w[..., 0, :] + g[..., 1, :] * w[..., 1, :] + (
        g[..., 2, :] * w[..., 2, :])
    return torch.where(exist[..., None], t, torch.full_like(t, -2.0))


def source_points(cam, verts, faces, viewing_angle=30.0):
    """Source-image xy of each face's vertices, y un-flipped: (B, F, 3, 2)."""
    xy = project_faces(cam, verts, faces, viewing_angle)[..., 0:2]
    return xy * torch.tensor([1.0, -1.0], device=xy.device)


def smpl_flow_warp(src_img, src_cam, src_verts, tgt_cam, tgt_verts, faces,
                   S, near=0.1, far=25.0, viewing_angle=30.0):
    """Warp (B, C, S, S) source images from the source pose to the target
    pose through the target's z-buffer: (B, C, S, S)."""
    src = source_points(src_cam, src_verts, faces, viewing_angle)
    fim, wim = zbuffer(project_faces(tgt_cam, tgt_verts, faces,
                                     viewing_angle), S, near, far)
    return grid_sample(src_img, barycentric_grid(src, fim, wim), "border")
