"""Bilinear sampling and resizing (port of ``jafpro_tpu/ops/sampling.py``).

Layout is PyTorch's: images (B, C, H, W), sampling grids (B, Hg, Wg, 2)
with ``grid[..., 0]`` = x, as ``F.grid_sample`` takes them. Semantics are
``grid_sample`` with ``align_corners=True``. The arithmetic follows the JAX
package step for step (unnormalize, floor, four weighted corner gathers;
border padding clamps the corner indices, not the coordinates), so the two
agree to rounding. Resizes are two matmuls with the same interpolation
matrices as the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> [0, size-1] with align_corners=True."""
    return (coord + 1.0) * 0.5 * (size - 1)


def _gather_2d(image: torch.Tensor, yi: torch.Tensor,
               xi: torch.Tensor) -> torch.Tensor:
    """image[b, :, yi[b, ...], xi[b, ...]] -> (B, C, *idx_shape[1:])."""
    B, C, H, W = image.shape
    idx = (yi * W + xi).reshape(B, 1, -1).expand(B, C, -1)
    out = torch.gather(image.reshape(B, C, H * W), 2, idx)
    return out.reshape(B, C, *yi.shape[1:])


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    padding_mode: str = "zeros",
    mode: str = "bilinear",
    pixel_coords: bool = False,
) -> torch.Tensor:
    """Sample ``image`` (B, C, H, W) at ``grid`` (B, Hg, Wg, 2) locations.

    ``grid`` holds normalized [-1, 1] coords (align_corners=True), or raw
    pixel coords with ``pixel_coords=True``. ``padding_mode`` is "zeros"
    or "border"; ``mode`` "bilinear" or "nearest". Returns (B, C, Hg, Wg).
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode: {mode}")
    B, C, H, W = image.shape
    if pixel_coords:
        x, y = grid[..., 0], grid[..., 1]
    else:
        x = _unnormalize(grid[..., 0], W)
        y = _unnormalize(grid[..., 1], H)

    if mode == "nearest":
        xi = torch.floor(x + 0.5).to(torch.int64)
        yi = torch.floor(y + 0.5).to(torch.int64)
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        out = _gather_2d(image, yi.clamp(0, H - 1), xi.clamp(0, W - 1))
        if padding_mode == "zeros":
            out = torch.where(valid[:, None], out, torch.zeros_like(out))
        return out

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = x0i + 1
    y1i = y0i + 1

    def corner(yi, xi, w):
        v = _gather_2d(image, yi.clamp(0, H - 1), xi.clamp(0, W - 1))
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            w = w * valid.to(image.dtype)
        return v * w.to(image.dtype)[:, None]

    return (corner(y0i, x0i, (1 - wy) * (1 - wx))
            + corner(y0i, x1i, (1 - wy) * wx)
            + corner(y1i, x0i, wy * (1 - wx))
            + corner(y1i, x1i, wy * wx))


def resample2d(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image`` (B, C, H, W) by a pixel-displacement
    ``flow`` (B, 2, H, W), channel 0 = dx, 1 = dy: output(p) =
    image(p + flow(p)), bilinear, zero padding (the reference's
    ``resample2d_cuda``). As the JAX package computes it: the sample
    point is normalised with align corners and handed to
    ``grid_sample``."""
    H, W = flow.shape[-2:]
    ys = torch.arange(H, dtype=flow.dtype, device=flow.device)
    xs = torch.arange(W, dtype=flow.dtype, device=flow.device)
    sx = xs[None, None, :] + flow[:, 0]
    sy = ys[None, :, None] + flow[:, 1]
    gx = 2.0 * sx / (W - 1) - 1.0
    gy = 2.0 * sy / (H - 1) - 1.0
    return grid_sample(image, torch.stack([gx, gy], dim=-1),
                       padding_mode="zeros")


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int,
                   align_corners: bool) -> np.ndarray:
    """(out_size, in_size) linear interpolation weights (torch
    ``F.interpolate(mode='bilinear')`` semantics along one axis)."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
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


def _interp_tensor(in_size, out_size, align_corners, device):
    return torch.from_numpy(
        _interp_matrix(in_size, out_size, align_corners)).to(device)


def resize_bilinear(x: torch.Tensor, size: tuple,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (B, C, size[0], size[1]),
    computed in float32 as rows then columns, cast back to ``x.dtype``."""
    H, W = x.shape[-2:]
    Ho, Wo = size
    if (H, W) == (Ho, Wo):
        return x
    wh = _interp_tensor(H, Ho, align_corners, x.device)
    ww = _interp_tensor(W, Wo, align_corners, x.device)
    y = torch.matmul(wh, x.float())                 # (..., Ho, W)
    y = torch.matmul(y, ww.t())                     # (..., Ho, Wo)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    # torch F.interpolate(mode='nearest'): src = floor(dst * in/out)
    return np.minimum(np.arange(out_size) * in_size // out_size,
                      in_size - 1).astype(np.int64)


def resize_nearest(x: torch.Tensor, size: tuple) -> torch.Tensor:
    """Nearest resize of (B, C, H, W), torch ``mode='nearest'``."""
    H, W = x.shape[-2:]
    Ho, Wo = size
    if (H, W) == (Ho, Wo):
        return x
    yi = torch.from_numpy(_nearest_index(H, Ho)).to(x.device)
    xi = torch.from_numpy(_nearest_index(W, Wo)).to(x.device)
    return x[..., yi, :][..., xi]
