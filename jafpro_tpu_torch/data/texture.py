"""DensePose texture atlas warps (port of ``jafpro_tpu/data/texture.py``).

Layouts are the JAX package's: parts (B, P, p, p, C), atlas
(B, 4p, 6p, C), IUV maps (B, S, S, 3) with channel 0 the part id
(0 = background, 1..24) and channels 1, 2 U and V in 0..255; warped
images come out channels-last, (B, S, S, C). A texture whose batch is 1
serves every IUV map of the batch without being copied. The host helpers
(``unwrap_texture``, ``iuv_to_part_masks``, ``texture_fusion``) are NumPy
and ``cv2``, which they import when called.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jafpro_tpu_torch.ops.sampling import _interp_tensor


def atlas_to_parts(atlas: torch.Tensor, part_size: int = 200) -> torch.Tensor:
    """(B, 4*p, 6*p, C) -> (B, 24, p, p, C)."""
    B, H, W, C = atlas.shape
    rows, cols = H // part_size, W // part_size
    x = atlas.reshape(B, rows, part_size, cols, part_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        B, rows * cols, part_size, part_size, C)


def parts_to_atlas(parts: torch.Tensor) -> torch.Tensor:
    """(B, 24, p, p, C) -> (B, 4*p, 6*p, C)."""
    B, P, ph, pw, C = parts.shape
    rows, cols = 4, P // 4
    x = parts.reshape(B, rows, cols, ph, pw, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, rows * ph, cols * pw, C)


def _batch_index(table: torch.Tensor, n: int) -> torch.Tensor:
    """(n, 1) row index into ``table``'s batch (0 when it is shared)."""
    b = torch.arange(n, device=table.device)
    if table.shape[0] == 1:
        b = torch.zeros_like(b)
    elif table.shape[0] != n:
        raise ValueError(f"table batch {table.shape[0]} vs IUV batch {n}")
    return b[:, None]


def texture_warp_atlas(atlas: torch.Tensor, iuv255: torch.Tensor,
                       num_parts: int = 24) -> torch.Tensor:
    """Warp an assembled (B, 4p, 6p, C) atlas through (B, S, S, 3) IUV
    maps: per part a bilinear, align_corners sample of the tile at
    x = (255-V)/255*(p-1), y = U/255*(p-1), gathered at the tile's offset
    into the atlas. Returns (B, S, S, C), 0 outside the body."""
    Ha, Wa, C = atlas.shape[1:]
    p = Ha // 4
    B = iuv255.shape[0]
    pid, u, v = iuv255[..., 0], iuv255[..., 1], iuv255[..., 2]
    part = torch.clamp(pid.to(torch.int64) - 1, 0, num_parts - 1)
    row = part // 6
    col = part % 6

    gx = ((255.0 - v) / 255.0 - 0.5) * 2.0
    gy = (u / 255.0 - 0.5) * 2.0
    x_loc = (gx + 1.0) * 0.5 * (p - 1)
    y_loc = (gy + 1.0) * 0.5 * (p - 1)
    x0 = torch.floor(x_loc)
    y0 = torch.floor(y_loc)
    wx = x_loc - x0
    wy = y_loc - y0
    x0i = torch.clamp(x0.to(torch.int64) + col * p, 0, Wa - 1)
    y0i = torch.clamp(y0.to(torch.int64) + row * p, 0, Ha - 1)
    x1i = torch.clamp(x0i + 1, 0, Wa - 1)
    y1i = torch.clamp(y0i + 1, 0, Ha - 1)

    flat = atlas.reshape(atlas.shape[0], Ha * Wa, C)
    b = _batch_index(atlas, B)

    def tap(yi, xi):
        return flat[b, (yi * Wa + xi).reshape(B, -1)].reshape(
            *yi.shape, C)

    out = (tap(y0i, x0i) * ((1 - wy) * (1 - wx))[..., None]
           + tap(y0i, x1i) * ((1 - wy) * wx)[..., None]
           + tap(y1i, x0i) * (wy * (1 - wx))[..., None]
           + tap(y1i, x1i) * (wy * wx)[..., None])
    return torch.where((pid > 0)[..., None], out, torch.zeros_like(out))


def texture_warp(parts: torch.Tensor, iuv255: torch.Tensor,
                 num_parts: int = 24) -> torch.Tensor:
    """``texture_warp_atlas`` of (B, 24, p, p, C) texture tiles: (B, S, S, C),
    0 outside the body. Where many IUV maps share a texture, assemble the
    atlas once with ``parts_to_atlas`` and call ``texture_warp_atlas``."""
    return texture_warp_atlas(parts_to_atlas(parts), iuv255, num_parts)


def build_texture_warp_lut(parts: torch.Tensor,
                           grid: int = 256) -> torch.Tensor:
    """Warp table for integer-valued IUV: (B, P, p, p, C) tiles ->
    (B, P, grid, grid, C), ``lut[b, k, u, v]`` the warped value for part
    id k+1 at (U, V) = (u, v). Two matmuls with the bilinear interpolation
    matrices: rows at y = u*(p-1)/255, columns at x = (255-v)*(p-1)/255."""
    p = parts.shape[2]
    wy = _interp_tensor(p, grid, True, parts.device)
    wx = torch.flip(wy, dims=[0])
    x = parts.float()
    y = torch.einsum("up,bkpqc->bkuqc", wy, x)
    y = torch.einsum("vq,bkuqc->bkuvc", wx, y)
    return y.to(parts.dtype)


def texture_warp_lut(lut: torch.Tensor, iuv255: torch.Tensor) -> torch.Tensor:
    """Single-tap warp through a ``build_texture_warp_lut`` table
    (the JAX ``impl="tap"`` form): lut (B or 1, P, G, G, C), iuv255
    (B, S, S, 3) -> (B, S, S, C), 0 outside the body. U and V round to the
    nearest lattice point."""
    _, P, G, _, C = lut.shape
    B = iuv255.shape[0]
    pid = iuv255[..., 0]
    part = torch.clamp(pid.to(torch.int64) - 1, 0, P - 1)
    u = torch.clamp(torch.floor(iuv255[..., 1] + 0.5).to(torch.int64), 0, G - 1)
    v = torch.clamp(torch.floor(iuv255[..., 2] + 0.5).to(torch.int64), 0, G - 1)
    idx = ((part * G + u) * G + v).reshape(B, -1)
    flat = lut.reshape(lut.shape[0], P * G * G, C)
    out = flat[_batch_index(lut, B), idx].reshape(*pid.shape, C)
    return torch.where((pid > 0)[..., None], out, torch.zeros_like(out))


def _part_texels(iuv255: np.ndarray, part: int, tex_size: int):
    """Rows and columns, in a ``tex_size`` tile, of the texels that the
    pixels of ``part`` see, and those pixels' coordinates."""
    sol = float(tex_size) - 1
    ys, xs = np.where(iuv255[..., 0] == part)
    ti = ((255 - iuv255[ys, xs, 2]) * sol / 255.0).astype(int)
    tj = (iuv255[ys, xs, 1] * sol / 255.0).astype(int)
    return ys, xs, ti, tj


def unwrap_texture(image: np.ndarray, iuv255: np.ndarray, tex_size: int = 32,
                   part_size: int = 200) -> np.ndarray:
    """Image (S, S, 3) BGR + IUV -> (24, part, part, 3) partial texture
    tiles, RGB in [0, 1] (the reference's ``get_texture``): a nearest
    scatter into ``tex_size`` tiles, then a bilinear resize to
    ``part_size``; a part no pixel sees stays 0."""
    import cv2

    out = np.zeros((24, part_size, part_size, 3), np.float32)
    for p in range(1, 25):
        ys, xs, ti, tj = _part_texels(iuv255, p, tex_size)
        if len(ys):
            tile = np.zeros((tex_size, tex_size, 3), np.float64)
            tile[ti, tj] = image[ys, xs]
            resized = cv2.resize(tile, (part_size, part_size),
                                 interpolation=cv2.INTER_LINEAR)
            out[p - 1] = resized[:, :, ::-1] / 255.0
    return out


def iuv_to_part_masks(iuv255: np.ndarray, tex_size: int = 32,
                      part_size: int = 200) -> np.ndarray:
    """Visibility of each part's texture tile: (24, part, part) in {0, 1}."""
    import cv2

    out = np.zeros((24, part_size, part_size), np.float32)
    for p in range(1, 25):
        ys, xs, ti, tj = _part_texels(iuv255, p, tex_size)
        if len(ys):
            tile = np.zeros((tex_size, tex_size), np.float64)
            tile[ti, tj] = 1.0
            out[p - 1] = (cv2.resize(tile, (part_size, part_size),
                                     interpolation=cv2.INTER_LINEAR) > 0
                          ).astype(np.float32)
    return out


def transfer_texture(atlas: np.ndarray, iuv255: np.ndarray,
                     part_size: int = 200) -> np.ndarray:
    """Nearest-texel atlas -> image warp on the host (the reference's
    ``TransferTexture``, ``src/utils.py:369-394``): each target pixel takes
    the texel at its rounded UV in its part's tile. atlas (4p, 6p[, C]),
    iuv255 (S, S, 3) -> (S, S[, C]), zeros at the background."""
    p = part_size
    pid = iuv255[..., 0].astype(np.int32)
    U = np.rint(iuv255[..., 1] / 255.0 * (p - 1)).astype(np.int64)
    V = np.rint(iuv255[..., 2] / 255.0 * (p - 1)).astype(np.int64)
    out = np.zeros(iuv255.shape[:2] + atlas.shape[2:], atlas.dtype)
    for part in range(1, 25):
        i_cor = (part - 1) // 6
        j_cor = part - i_cor * 6 - 1
        tex = atlas[i_cor * p:(i_cor + 1) * p, j_cor * p:(j_cor + 1) * p]
        ys, xs = np.where(pid == part)
        out[ys, xs] = tex[U[ys, xs], (p - 1) - V[ys, xs]]
    return out


def masks_to_atlas(part_masks: np.ndarray) -> np.ndarray:
    """(24, p, p) -> (4p, 6p) atlas-layout mask."""
    p = part_masks.shape[1]
    out = np.zeros((4 * p, 6 * p), part_masks.dtype)
    for i in range(24):
        r, c = i // 6, i % 6
        out[r * p:(r + 1) * p, c * p:(c + 1) * p] = part_masks[i]
    return out


def texture_fusion(texture1: np.ndarray, texture2: np.ndarray,
                   mask1: np.ndarray, mask2: np.ndarray, radius: int = 7):
    """Greedy two-atlas fusion (the reference's ``Texture_fusion``): keep
    texture1 wherever it is observed and fill from texture2 only outside
    a band dilated around their overlap. Textures (H, W, 3) uint8-range,
    masks (H, W) 0..255. Returns (fused texture, observed mask * 255,
    area to inpaint * 255)."""
    import cv2

    m1 = (mask1 / 255).astype(np.uint8)
    m2 = (mask2 / 255).astype(np.uint8)
    inter = np.logical_and(m1, m2).astype(np.float64)
    dilated = cv2.dilate(inter, np.ones((radius, radius), np.uint8)
                         ).astype(np.uint8)
    non_overlap = np.subtract(m2, dilated, dtype=np.uint8)
    complement = (non_overlap[..., None].repeat(3, 2) * texture2).astype(
        texture1.dtype)
    observed = m1 + non_overlap * m2
    inpaint = np.subtract(1, observed, dtype=np.uint8)
    return (complement + texture1, (observed * 255).astype(np.uint8),
            (inpaint * 255).astype(np.uint8))


def write_gif(path: str, frames: np.ndarray, fps: int = 10) -> str:
    """GIF export with PIL (imported here). frames: (T, H, W[, 3]) floats
    in [0, 1] or uint8. Writes ``<path without extension>.gif``."""
    from PIL import Image

    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = np.repeat(frames[..., None], 3, -1)
    if frames.dtype != np.uint8:
        frames = np.clip(frames * 255, 0, 255).astype(np.uint8)
    imgs = [Image.fromarray(f) for f in frames]
    path = os.path.splitext(path)[0] + ".gif"
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path
