"""Weak-perspective camera and view transform
(port of ``jafpro_tpu/geometry/projection.py``)."""

from __future__ import annotations

import numpy as np
import torch


def orthographic_proj_withz_idrot(X: torch.Tensor, cam: torch.Tensor,
                                  offset_z: float = 0.0) -> torch.Tensor:
    """X: (B, N, 3); cam: (B, 3) = [scale, tx, ty]. xy -> s*(xy+t), keep z."""
    scale = cam[:, 0][:, None, None]
    trans = cam[:, 1:3][:, None, :]
    xy = scale * (X[..., :2] + trans)
    z = X[..., 2:3] + offset_z
    return torch.cat([xy, z], dim=-1)


def default_eye(viewing_angle: float = 30.0) -> np.ndarray:
    return np.array(
        [0.0, 0.0, -(1.0 / np.tan(np.radians(viewing_angle)) + 1.0)],
        dtype=np.float32)


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # torch F.normalize(eps=...): v / max(||v||, eps)
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def look_at(vertices: torch.Tensor, eye, at=(0.0, 0.0, 0.0),
            up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """General "look at" view transform on (B, N, 3) vertices."""
    def as_batch(v):
        t = torch.as_tensor(np.asarray(v), dtype=vertices.dtype,
                            device=vertices.device)
        return t[None] if t.ndim == 1 else t

    eye, at, up = as_batch(eye), as_batch(at), as_batch(up)
    z_axis = _normalize(at - eye)
    x_axis = _normalize(torch.linalg.cross(up.expand_as(z_axis), z_axis))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis))
    r = torch.stack([x_axis, y_axis, z_axis], dim=1)  # (B, 3, 3)
    return torch.einsum("bni,bji->bnj", vertices - eye[:, None, :], r)


def project_to_view(vertices: torch.Tensor, cam: torch.Tensor,
                    viewing_angle: float = 30.0) -> torch.Tensor:
    """Weak-perspective project, flip y, translate by -eye (the camera's
    rotation is the identity). Returns view-space vertices whose xy are in
    [-1, 1] image coords (y down) and z is camera depth."""
    proj = orthographic_proj_withz_idrot(vertices, cam)
    proj = torch.cat([proj[..., :1], proj[..., 1:2] * -1.0, proj[..., 2:]],
                     dim=-1)
    eye = torch.as_tensor(default_eye(viewing_angle), dtype=proj.dtype,
                          device=proj.device)
    return proj - eye


def vertices_to_faces(vertices: torch.Tensor,
                      faces: torch.Tensor) -> torch.Tensor:
    """Gather (B, V, 3) vertices into (B, F, 3, 3) per-face triangles."""
    return vertices[:, faces]


def project_to_view_np(vertices: np.ndarray, cam: np.ndarray,
                       viewing_angle: float = 30.0) -> np.ndarray:
    """NumPy twin of ``project_to_view``. vertices: (B, V, 3); cam: (B, 3)."""
    vertices = np.asarray(vertices, np.float32)
    cam = np.asarray(cam, np.float32)
    scale = cam[:, 0][:, None, None]
    trans = cam[:, 1:3][:, None, :]
    xy = scale * (vertices[..., :2] + trans)
    proj = np.concatenate([xy, vertices[..., 2:3]], axis=-1)
    proj[..., 1] *= -1.0
    return proj - default_eye(viewing_angle)
