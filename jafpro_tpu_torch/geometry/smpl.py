"""Batched SMPL body model: linear blend skinning in PyTorch
(port of ``jafpro_tpu/geometry/smpl.py``).

Shape blendshapes -> joint regression -> per-joint Rodrigues rotations ->
pose blendshapes -> kinematic-chain global transforms -> LBS skinning ->
cocoplus joints. Batched matmuls except the 24-step kinematic chain, which
is unrolled: on the card it is a chain of small launches (host-bound).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import numpy as np
import torch

from jafpro_tpu_torch.device import resolve_device


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3), with the
    reference's ``theta + 1e-8`` norm regularisation."""
    angle = torch.linalg.norm(theta + 1e-8, dim=1, keepdim=True)  # (N, 1)
    r = theta / angle
    cos = torch.cos(angle)[..., None]                            # (N, 1, 1)
    sin = torch.sin(angle)[..., None]
    outer = r[:, :, None] * r[:, None, :]
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    zeros = torch.zeros_like(r[:, 0])
    K = torch.stack([
        torch.stack([zeros, -r[:, 2], r[:, 1]], dim=1),
        torch.stack([r[:, 2], zeros, -r[:, 0]], dim=1),
        torch.stack([-r[:, 1], r[:, 0], zeros], dim=1),
    ], dim=1)
    return cos * eye + (1.0 - cos) * outer + sin * K


def _make_A(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotation + (N, 3) translation -> (N, 4, 4) homogeneous."""
    top = torch.cat([R, t[:, :, None]], dim=2)                   # (N, 3, 4)
    bottom = R.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(R.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


def batch_global_rigid_transformation(
    Rs: torch.Tensor, Js: torch.Tensor, parents: np.ndarray,
) -> tuple:
    """Kinematic chain. Rs: (N, 24, 3, 3); Js: (N, 24, 3); parents:
    static (24,) int. Returns (new_J (N, 24, 3), A (N, 24, 4, 4)), the
    relative transforms LBS applies."""
    results = [_make_A(Rs[:, 0], Js[:, 0])]
    for i in range(1, parents.shape[0]):
        p = int(parents[i])
        A_here = _make_A(Rs[:, i], Js[:, i] - Js[:, p])
        results.append(torch.matmul(results[p], A_here))
    results = torch.stack(results, dim=1)                        # (N,24,4,4)
    new_J = results[:, :, :3, 3]
    # A = results - pack(results @ [J; 0]): skinning uses bone displacement
    Js_w0 = torch.cat([Js, torch.zeros_like(Js[..., :1])], dim=2)
    init_bone = torch.einsum("nkij,nkj->nki", results, Js_w0)    # (N,24,4)
    pad = torch.cat([torch.zeros_like(results[..., :3]),
                     init_bone[..., None]], dim=-1)
    return new_J, results - pad


@dataclasses.dataclass
class SMPLModel:
    """SMPL parameters as tensors on one device (``from_pkl`` reads the
    standard pkl; ``synthetic`` seeds a model of any size)."""

    v_template: torch.Tensor     # (V, 3)
    shapedirs: torch.Tensor      # (num_betas, V*3)
    posedirs: torch.Tensor       # (207, V*3)
    J_regressor: torch.Tensor    # (V, 24)
    weights: torch.Tensor        # (V, 24)
    parents: np.ndarray          # (24,) static
    joint_regressor: Optional[torch.Tensor] = None  # (V, 19)
    faces: Optional[np.ndarray] = None              # (F, 3) int32

    @classmethod
    def _from_arrays(cls, device, faces=None, **arrays) -> "SMPLModel":
        dev = resolve_device(device)
        t = {k: None if v is None else torch.as_tensor(
            np.asarray(v, np.float32)).to(dev) for k, v in arrays.items()
            if k != "parents"}
        return cls(parents=np.asarray(arrays["parents"], np.int32),
                   faces=faces, **t)

    @classmethod
    def from_pkl(cls, path: str, device="cuda") -> "SMPLModel":
        """The standard SMPL pkl (scipy sparse regressors are densified).
        A pickle runs code when loaded: read only files you trust."""
        with open(path, "rb") as f:
            dd = pickle.load(f, encoding="latin1")

        def dense(x):
            return (np.asarray(x.todense()) if hasattr(x, "todense")
                    else np.asarray(x))

        num_betas = dd["shapedirs"].shape[-1]
        return cls._from_arrays(
            device,
            v_template=dd["v_template"],
            shapedirs=np.asarray(dd["shapedirs"], np.float32).reshape(
                -1, num_betas).T,
            posedirs=np.asarray(dd["posedirs"], np.float32).reshape(
                -1, 207).T,
            J_regressor=dense(dd["J_regressor"]).T,
            weights=dd["weights"],
            parents=np.asarray(dd["kintree_table"][0]),
            joint_regressor=(dense(dd["cocoplus_regressor"]).T
                             if "cocoplus_regressor" in dd else None),
            faces=np.asarray(dd["f"], np.int32) if "f" in dd else None)

    @classmethod
    def synthetic(cls, num_verts: int = 64, num_betas: int = 10,
                  seed: int = 0, v_template: Optional[np.ndarray] = None,
                  faces: Optional[np.ndarray] = None,
                  device="cuda") -> "SMPLModel":
        """A random model (no SMPL pkl needed). The numpy draws are the JAX
        package's ``SMPLModel.synthetic``'s, so one seed gives both
        packages the same model. A given ``v_template`` (V, 3) replaces the
        drawn one (the draws stay the same) and sets ``num_verts``."""
        rng = np.random.RandomState(seed)
        V = num_verts if v_template is None else len(v_template)
        parents = np.concatenate([[0], np.arange(23)]).astype(np.int32)
        Jr = rng.rand(V, 24).astype(np.float32)
        Jr /= Jr.sum(0, keepdims=True)
        W = rng.rand(V, 24).astype(np.float32)
        W /= W.sum(1, keepdims=True)
        vt = rng.randn(V, 3).astype(np.float32)
        if v_template is not None:
            vt = np.asarray(v_template, np.float32)
        return cls._from_arrays(
            device,
            v_template=vt,
            shapedirs=0.01 * rng.randn(num_betas, V * 3).astype(np.float32),
            posedirs=0.001 * rng.randn(207, V * 3).astype(np.float32),
            J_regressor=Jr, weights=W, parents=parents,
            joint_regressor=(rng.rand(V, 19) / V).astype(np.float32),
            faces=None if faces is None else np.asarray(faces, np.int32))

    def __call__(self, beta: torch.Tensor, theta: torch.Tensor,
                 get_skin: bool = True):
        """beta: (N, num_betas), theta: (N, 72) axis-angle (global rotation
        first). Returns (verts (N, V, 3), joints (N, 19, 3), Rs
        (N, 24, 3, 3)) when ``get_skin``, else joints."""
        N = beta.shape[0]
        V = self.v_template.shape[0]
        v_shaped = (beta @ self.shapedirs).reshape(N, V, 3) + self.v_template
        J = torch.einsum("nvc,vk->nkc", v_shaped, self.J_regressor)

        Rs = batch_rodrigues(theta.reshape(-1, 3)).reshape(N, 24, 3, 3)
        eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
        pose_feature = (Rs[:, 1:] - eye).reshape(N, 207)
        v_posed = (pose_feature @ self.posedirs).reshape(N, V, 3) + v_shaped

        _, A = batch_global_rigid_transformation(Rs, J, self.parents)

        T = torch.einsum("vk,nkij->nvij", self.weights, A)        # (N,V,4,4)
        v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=2)
        verts = torch.einsum("nvij,nvj->nvi", T, v_h)[..., :3]

        reg = (self.joint_regressor if self.joint_regressor is not None
               else self.J_regressor)
        joints = torch.einsum("nvc,vk->nkc", verts, reg)
        if get_skin:
            return verts, joints, Rs
        return joints
