"""SMPL barycentric flow engine (port of ``jafpro_tpu/geometry/flow.py``).

Render the target pose to face-index/weight maps, move each target pixel
to the source-image location of its face's vertices blended by the
barycentric weights, then backward-warp the source image. The engine
always rasterizes through ``rasterize_fim_wim`` (the CUDA kernel on the
card), the counterpart of the JAX engine's ``backend="pallas"``; the JAX
engine's band, crop and tile culls are TPU-only and have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from jafpro_tpu_torch.config import default_smpl_faces_path
from jafpro_tpu_torch.geometry.projection import (
    project_to_view, vertices_to_faces)
from jafpro_tpu_torch.geometry.rasterizer import rasterize_fim_wim
from jafpro_tpu_torch.ops.sampling import grid_sample


def cal_bc_transform(src_f2pts: torch.Tensor, dst_fims: torch.Tensor,
                     dst_wims: torch.Tensor) -> torch.Tensor:
    """Barycentric transform map.

    Args:
      src_f2pts: (B, F, 3, 2) source-image xy of each face's vertices.
      dst_fims:  (B, S, S) int target face-index map (-1 = background).
      dst_wims:  (B, S, S, 3) target barycentric weights.
    Returns:
      (B, S, S, 2) sampling grid into the source image; -2 at background.
    """
    B = dst_fims.shape[0]
    exist = dst_fims >= 0
    safe = torch.where(exist, dst_fims, torch.zeros_like(dst_fims)).long()
    bidx = torch.arange(B, device=safe.device).view(B, 1, 1)
    g = src_f2pts[bidx, safe]  # (B, S, S, 3, 2)
    w = dst_wims[..., None]
    t = g[..., 0, :] * w[..., 0, :] + g[..., 1, :] * w[..., 1, :] + (
        g[..., 2, :] * w[..., 2, :])
    return torch.where(exist[..., None], t, torch.full_like(t, -2.0))


@dataclasses.dataclass
class SMPLFlowEngine:
    """Holds the static face topology (``faces`` (F, 3) int)."""

    faces: np.ndarray
    image_size: int = 256
    near: float = 0.1
    far: float = 25.0
    viewing_angle: float = 30.0

    @classmethod
    def create(cls, faces: Optional[np.ndarray] = None,
               image_size: int = 256, **kw) -> "SMPLFlowEngine":
        if faces is None:
            path = default_smpl_faces_path()
            if path is None:
                raise FileNotFoundError(
                    "smpl_faces.npy not found; set JAFPRO_SMPL_FACES or "
                    "pass faces")
            faces = np.load(path)
        return cls(faces=np.asarray(faces, np.int32), image_size=image_size,
                   **kw)

    def project_faces(self, cam: torch.Tensor,
                      vertices: torch.Tensor) -> torch.Tensor:
        """View-space face vertices: (B, 3), (B, V, 3) -> (B, F, 3, 3)."""
        view = project_to_view(vertices, cam, self.viewing_angle)
        faces = torch.as_tensor(self.faces, dtype=torch.long,
                                device=view.device)
        return vertices_to_faces(view, faces)

    def render_fim_wim(self, cam: torch.Tensor, vertices: torch.Tensor):
        """(B, 3), (B, V, 3) -> (f2verts (B,F,3,3), fim (B,S,S), wim (B,S,S,3))."""
        fv = self.project_faces(cam, vertices)
        fim, wim = rasterize_fim_wim(fv.contiguous(), self.image_size,
                                     self.near, self.far)
        return fv, fim, wim

    def cal_flow(self, src_cam, src_vertices, tgt_cam, tgt_vertices):
        """Dense target->source sampling grid (B, S, S, 2) in the source
        image's normalized coords (source y un-flipped)."""
        src_f2pts = self.project_faces(src_cam, src_vertices)[..., 0:2]
        src_f2pts = src_f2pts * src_f2pts.new_tensor([1.0, -1.0])
        _, fim, wim = self.render_fim_wim(tgt_cam, tgt_vertices)
        return cal_bc_transform(src_f2pts, fim, wim)

    def warp_image(self, src_image: torch.Tensor,
                   flow: torch.Tensor) -> torch.Tensor:
        """Border-padded bilinear sample; src_image (B, C, S, S)."""
        return grid_sample(src_image, flow, padding_mode="border")

    def __call__(self, src_img, src_cam, src_vertices, tgt_cam,
                 tgt_vertices) -> torch.Tensor:
        """tsf_image (B, C, S, S) = warp(src_img, flow(src -> tgt))."""
        flow = self.cal_flow(src_cam, src_vertices, tgt_cam, tgt_vertices)
        return self.warp_image(src_img, flow)


def swap_smpl(src_cam: torch.Tensor, src_shape: torch.Tensor,
              tgt_smpl: torch.Tensor, first_cam: torch.Tensor,
              cam_strategy: str = "smooth") -> torch.Tensor:
    """Motion-transfer SMPL recomposition (the reference's ``swap_smpl``):
    the target's pose, the source's shape and a camera by strategy —
    "smooth": the source camera moved by the target's xy drift from the
    first frame; "source": the source camera; else the target's.
    tgt_smpl (B, 85) = [cam (3), pose (72), shape (10)] -> (B, 85)."""
    tgt_cam = tgt_smpl[:, 0:3]
    pose = tgt_smpl[:, 3:75]
    if cam_strategy == "smooth":
        delta_xy = tgt_cam[:, 1:] - first_cam[:, 1:]
        cam = torch.cat([src_cam[:, :1], src_cam[:, 1:] + delta_xy], dim=1)
    elif cam_strategy == "source":
        cam = src_cam
    else:
        cam = tgt_cam
    return torch.cat([cam, pose, src_shape], dim=1)
