"""DensePose texture atlas warps (port of ``jafpro_tpu/data/texture.py``).

Layouts are the JAX package's: parts (B, P, p, p, C), atlas
(B, 4p, 6p, C), IUV maps (B, S, S, 3) with channel 0 the part id
(0 = background, 1..24) and channels 1, 2 U and V in 0..255; warped
images come out channels-last, (B, S, S, C). A texture whose batch is 1
serves every IUV map of the batch without being copied.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jafpro_tpu_torch.ops.sampling import _interp_tensor


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
