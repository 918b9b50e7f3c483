"""The SMPL renderer (port of ``jafpro_tpu/geometry/renderer.py``).

Maps as the JAX package gives them: face-index ``fim`` (B, S, S), weights
``wim`` (B, S, S, 3), depth and silhouettes (B, S, S), ``encode_fim``
(B, S, S, C). Images in the port's layout, NCHW: ``extract_tex`` takes
(B, 3, H, W) and ``render`` returns (B, 3, S, S), the JAX package's
(B, H, W, 3) permuted. Texture cubes are (B, F, T, T, T, 3) in both.

Every map comes from ``rasterize_fim_wim``: the CUDA kernel for CUDA
tensors (with its depth output for ``render_depth`` and ``render``), its
plain version for CPU tensors. Gradients: ``wim`` and depth are
differentiable in the vertices for a fixed winner (the rasterizer's
``_WinnerGrad``), textures through the gathers; ``edge_gradients=True``
adds the occlusion-boundary term (``edge_gradient_surrogate``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.geometry.projection import (
    orthographic_proj_withz_idrot, project_to_view, vertices_to_faces)
from jafpro_tpu_torch.geometry.rasterizer import rasterize_fim_wim
from jafpro_tpu_torch.ops.sampling import grid_sample


def _gather_faces(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (B, F, ...) at idx (B, S, S) -> (B, S, S, ...)."""
    bidx = torch.arange(arr.shape[0], device=arr.device).view(-1, 1, 1)
    return arr[bidx, idx]


def _shift_map(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``arr`` (B, S, S, ...) shifted so position (y, x) reads
    arr[y - dy, x - dx], ``fill`` where that falls outside."""
    S = arr.shape[1]
    out = torch.full_like(arr, fill)
    out[:, max(dy, 0):S + min(dy, 0), max(dx, 0):S + min(dx, 0)] = \
        arr[:, max(-dy, 0):S + min(-dy, 0), max(-dx, 0):S + min(-dx, 0)]
    return out


def edge_gradient_surrogate(fim: torch.Tensor, wim: torch.Tensor,
                            images: torch.Tensor,
                            px: torch.Tensor) -> torch.Tensor:
    """Occlusion-boundary (coverage) gradient term for rasterized maps
    (``renderer.py:39-111`` of the JAX package): exactly zero in the
    forward pass, its backward carries d(map)/d(vertex) across coverage
    boundaries, built from ``px - px.detach()``.

    Moving a face's silhouette outward by one pixel repaints each
    just-outside neighbour b from I_b to the covered pixel's I_a, so
    dI_b/d(edge shift) ~ (I_a - I_b); the edge moves with the face's
    vertices by the boundary pixel's barycentric weights.

    Args, all in the rasterizer's ``flip_y=False`` orientation:
      fim (B, S, S) int [-1 bg], wim (B, S, S, 3), images (B, S, S, C)
      the rendered values, px (B, F, 3, 2) pixel-space vertex coords from
      the differentiable view vertices, ``0.5 * (fv_xy * S + S - 1)``.
    """
    delta = px - px.detach()
    covered = fim >= 0
    delta_f = _gather_faces(delta, fim.clamp(min=0).long())   # (B,S,S,3,2)
    shift = torch.sum(wim.detach()[..., None] * delta_f, dim=-2)  # (B,S,S,2)
    out = torch.zeros_like(images)
    # (dy, dx, component, sign): the face at a = b - (dy, dx) grows toward
    # b when its vertices move by sign along component
    for dy, dx, comp, sign in ((0, 1, 0, 1.0), (0, -1, 0, -1.0),
                               (1, 0, 1, 1.0), (-1, 0, 1, -1.0)):
        fim_a = _shift_map(fim, dy, dx, -1)
        img_a = _shift_map(images, dy, dx, 0.0)
        cov_a = _shift_map(covered, dy, dx, False)
        shift_a = _shift_map(shift[..., comp], dy, dx, 0.0)
        mask = cov_a & (fim_a != fim)                 # boundary seen from b
        dI = (img_a - images).detach()                # repaint b -> a
        out = out + torch.where(mask[..., None],
                                dI * (sign * shift_a)[..., None],
                                torch.zeros_like(images))
    return out


def encode_fim(fim: torch.Tensor, map_fn: torch.Tensor) -> torch.Tensor:
    """fim (B, S, S) int with -1 bg; map_fn (F+1, C), last row the
    background. Returns (B, S, S, C)."""
    idx = torch.where(fim >= 0, fim, map_fn.shape[0] - 1).long()
    return map_fn[idx]


def points_to_sampler(coords: torch.Tensor,
                      faces_pts: torch.Tensor) -> torch.Tensor:
    """coords (2, T*T) barycentric alphas; faces_pts (B, F, 3, 2) ->
    (B, F, T*T, 2) clamped to [-1, 1]."""
    v2 = faces_pts[:, :, 2]
    basis = torch.stack([faces_pts[:, :, 0] - v2, faces_pts[:, :, 1] - v2],
                        dim=-1)                              # (B, F, 2, 2)
    samples = torch.einsum("bfij,jk->bfik", basis, coords) + v2[..., None]
    return torch.clamp(samples.transpose(2, 3), -1.0, 1.0)


def create_coords(tex_size: int = 3) -> np.ndarray:
    """(2, T*T) barycentric sample grid."""
    step = 1.0 if tex_size == 1 else 1.0 / (tex_size - 1)
    ab = np.arange(0, 1 + step, step, dtype=np.float32)[:tex_size]
    xv, yv = np.meshgrid(ab, ab, indexing="ij")
    return np.stack([xv.ravel(), yv.ravel()], axis=0)


@dataclasses.dataclass
class SMPLRenderer:
    """Renders (B, V, 3) vertices under (B, 3) weak-perspective cameras.
    ``faces`` (F, 3) int; everything runs on ``device`` (the card unless
    the caller asks for the CPU). The JAX renderer's ``chunk`` is a knob of
    its XLA rasterizer and has no counterpart."""

    faces: np.ndarray
    image_size: int = 256
    tex_size: int = 3
    near: float = 0.1
    far: float = 25.0
    viewing_angle: float = 30.0
    light_intensity_ambient: float = 1.0
    light_intensity_directional: float = 0.0
    light_color_ambient: Tuple[float, float, float] = (1, 1, 1)
    light_color_directional: Tuple[float, float, float] = (1, 1, 1)
    light_direction: Tuple[float, float, float] = (0, 1, 0)
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.faces_t = torch.as_tensor(np.asarray(self.faces),
                                       dtype=torch.long, device=self.device)
        self.coords = torch.from_numpy(create_coords(self.tex_size)).to(
            self.device)

    def _view_faces(self, cam, vertices):
        view = project_to_view(vertices, cam, self.viewing_angle)
        return vertices_to_faces(view, self.faces_t)

    def _rasterize(self, fv, return_depth=False):
        return rasterize_fim_wim(fv.contiguous(), self.image_size, self.near,
                                 self.far, return_depth=return_depth)

    def _edge_term(self, fv, fim, wim, maps):
        """``edge_gradient_surrogate`` in the output (y-flipped) rows."""
        S = self.image_size
        px = 0.5 * (fv[..., :2] * S + S - 1)
        surr = edge_gradient_surrogate(
            torch.flip(fim, [1]), torch.flip(wim, [1]),
            torch.flip(maps, [1]), px)
        return torch.flip(surr, [1])

    # ---- maps ----

    def render_fim_wim(self, cam, vertices):
        """-> (view-space faces (B, F, 3, 3), fim, wim)."""
        fv = self._view_faces(cam, vertices)
        fim, wim = self._rasterize(fv)
        return fv, fim, wim

    def render_fim(self, cam, vertices):
        return self.render_fim_wim(cam, vertices)[1]

    def render_silhouettes(self, cam, vertices, edge_gradients: bool = False):
        """Coverage map (B, S, S); ``edge_gradients=True`` makes it
        differentiable in the vertices and camera through the boundary
        surrogate."""
        fv, fim, wim = self.render_fim_wim(cam, vertices)
        sil = (fim >= 0).to(fv.dtype)
        if not edge_gradients:
            return sil
        return sil + self._edge_term(fv, fim, wim, sil[..., None])[..., 0]

    def render_depth(self, cam, vertices):
        """Per-pixel depth of the nearest face (B, S, S), 0 at background."""
        return self._rasterize(self._view_faces(cam, vertices), True)[2]

    # ---- texture extraction (dynamic sampling) ----

    def dynamic_sampler(self, cam, vertices):
        """(B, F, T*T, 2) image-space sample grids per face."""
        pts = orthographic_proj_withz_idrot(vertices, cam)[..., :2]
        faces_pts = vertices_to_faces(pts, self.faces_t)
        return points_to_sampler(self.coords.to(pts.dtype), faces_pts)

    def extract_tex(self, uv_img: torch.Tensor, sampler: torch.Tensor):
        """uv_img (B, 3, H, W), sampler (B, F, T*T, 2) -> (B, F, T, T, T, 3)
        texture cubes (constant along the last cube axis)."""
        B, F, TT, _ = sampler.shape
        T = self.tex_size
        tex = grid_sample(uv_img, sampler, padding_mode="zeros")  # (B,3,F,TT)
        tex = tex.permute(0, 2, 3, 1).reshape(B, F, T, T, 1, 3)
        return tex.expand(B, F, T, T, T, 3)

    def extract_tex_from_image(self, images, cam, vertices):
        return self.extract_tex(images, self.dynamic_sampler(cam, vertices))

    # ---- lighting ----

    def lighting(self, face_verts: torch.Tensor, textures: torch.Tensor):
        """face_verts (B, F, 3, 3) world coords; textures (B, F, T, T, T, 3):
        ambient + directional Lambertian modulation."""
        v10 = face_verts[:, :, 1] - face_verts[:, :, 0]
        v20 = face_verts[:, :, 2] - face_verts[:, :, 0]
        n = torch.linalg.cross(v10, v20)
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-8)
        light_dir = textures.new_tensor(self.light_direction)
        cos = torch.clamp(torch.einsum("bfc,c->bf", n, light_dir), min=0.0)
        amb = self.light_intensity_ambient * textures.new_tensor(
            self.light_color_ambient)
        dir_ = self.light_intensity_directional * textures.new_tensor(
            self.light_color_directional)
        light = amb + cos[..., None] * dir_                  # (B, F, 3)
        return textures * light[:, :, None, None, None, :]

    # ---- full textured render ----

    def render(self, cam, vertices, textures, get_fim: bool = False,
               edge_gradients: bool = False):
        """Textured render: depth-corrected barycentric texture coords and
        a trilinear blend over each face's (T, T, T) cube. textures
        (B, F, T, T, T, 3). Returns images (B, 3, S, S) [, fim].

        The 8 cube corners are gathered per pixel straight from the
        (B, F*T^3, 3) texture table, not from a per-pixel copy of the
        winner's whole cube (the JAX package's ``tex_pix``)."""
        textures = self.lighting(vertices_to_faces(vertices, self.faces_t),
                                 textures)
        fv = self._view_faces(cam, vertices)
        fim, wim, depth = self._rasterize(fv, return_depth=True)

        B, F = fv.shape[:2]
        T = self.tex_size
        found = fim >= 0
        safe = fim.clamp(min=0).long()
        face_z = _gather_faces(fv[..., 2], safe)             # (B, S, S, 3)

        # texture index k = clip(w_k (T-1) depth / z_k, 0, T-1-eps)
        tif = wim * (T - 1) * (depth[..., None] / face_z)
        tif = torch.clamp(tif, 0.0, T - 1 - 1e-3)
        lo_f = torch.floor(tif)
        frac = tif - lo_f
        lo = lo_f.long()

        table = textures.reshape(B, F * T ** 3, 3)
        base = safe * T ** 3
        out = 0.0
        for corner in range(8):
            w = torch.ones_like(tif[..., 0])
            idx = base
            for k in range(3):
                bit = (corner >> k) & 1
                w = w * (frac[..., k] if bit else 1.0 - frac[..., k])
                idx = idx + (lo[..., k] + bit) * T ** (2 - k)
            out = out + w[..., None] * _gather_faces(table, idx)
        images = torch.where(found[..., None], out, torch.zeros_like(out))
        if edge_gradients:
            images = images + self._edge_term(fv, fim, wim, images)
        images = images.permute(0, 3, 1, 2)
        if get_fim:
            return images, fim
        return images
