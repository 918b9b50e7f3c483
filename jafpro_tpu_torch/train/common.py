"""Shared training machinery (port of ``jafpro_tpu/train/common.py``):
per-module optimizers, the reference-count curriculum, the uint8 batch
expansion, and synthetic batches for tests.

The curriculum and the synthetic batches are numpy, drawing from a
``np.random.RandomState`` in the JAX package's order, so one seed gives
both packages the same batches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from jafpro_tpu_torch.data.shardio import (
    U8_SYMMETRIC_FIELDS, U8_UNIT_FIELDS)
from jafpro_tpu_torch.parallel.mesh import active_mesh, reduce_gradients
from jafpro_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class MultiStep:
    """A step-decay learning rate: ``base * gamma ** (milestones passed)``
    at update ``count`` (torch ``MultiStepLR``, optax's
    ``piecewise_constant_schedule``)."""

    base: float
    milestones: Tuple[int, ...]
    gamma: float

    def __call__(self, count: int) -> float:
        return self.base * self.gamma ** sum(count >= m
                                             for m in self.milestones)


def multistep_lr(base: float, milestones=(100_000, 150_000),
                 gamma: float = 0.3) -> MultiStep:
    """The reference's MultiStepLR (``train/1:94``)."""
    return MultiStep(float(base), tuple(int(m) for m in milestones),
                     float(gamma))


def adam(params, lr: float) -> torch.optim.Optimizer:
    """Adam at optax's defaults (beta 0.9 / 0.999, eps 1e-8 added outside
    the square root), which are torch's."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class TrainState:
    """One optimizer per trained module of ``pipe``.

    ``lrs``: module name -> learning rate (a float or a ``MultiStep``);
    modules absent from ``lrs`` are frozen (no optimizer). A ``MultiStep``
    rate gets a ``MultiStepLR`` stepped once per update of that module's
    optimizer, as optax counts its schedule. ``optimizer(params, lr)``
    builds each optimizer (default ``adam``). ``step`` counts
    ``apply_gradients`` calls, as the JAX ``TrainState`` does."""

    def __init__(self, pipe: torch.nn.Module,
                 lrs: Mapping[str, Union[float, MultiStep]],
                 optimizer: Callable = adam):
        self.params: Dict[str, list] = {}
        self.opts: Dict[str, torch.optim.Optimizer] = {}
        self.scheds: Dict[str, torch.optim.lr_scheduler.LRScheduler] = {}
        for name, lr in lrs.items():
            ps = list(getattr(pipe, name).parameters())
            self.params[name] = ps
            base = lr.base if isinstance(lr, MultiStep) else float(lr)
            self.opts[name] = optimizer(ps, base)
            if isinstance(lr, MultiStep):
                self.scheds[name] = torch.optim.lr_scheduler.MultiStepLR(
                    self.opts[name], list(lr.milestones), lr.gamma)
        self.step = 0

    def grads(self, loss: torch.Tensor,
              names: Sequence[str]) -> Dict[str, list]:
        """d loss / d (parameters of ``names``), per module. Parameters the
        loss does not reach get zeros, as in JAX. No other tensor's
        ``.grad`` is touched. Inside a data-parallel step each gradient is
        averaged over the ranks (``parallel.mesh.reduce_gradients``)."""
        flat = [p for n in names for p in self.params[n]]
        with span("train.backward", device=True, item=names):
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, gs)]
            mesh = active_mesh()
            if mesh is not None:
                reduce_gradients(gs, mesh)
        out, i = {}, 0
        for n in names:
            k = len(self.params[n])
            out[n] = gs[i:i + k]
            i += k
        return out

    def apply_gradients(self, grads: Mapping[str, Sequence[torch.Tensor]]):
        with span("train.update", device=True) as sp:
            if sp:
                sp.item = tuple(grads)
            for name, gs in grads.items():
                for p, g in zip(self.params[name], gs):
                    p.grad = g
                self.opts[name].step()
                self.opts[name].zero_grad(set_to_none=True)
                if name in self.scheds:
                    self.scheds[name].step()
        self.step += 1
        return self

    def state_dict(self) -> dict:
        return {"step": self.step,
                "opts": {k: o.state_dict() for k, o in self.opts.items()},
                "scheds": {k: s.state_dict() for k, s in self.scheds.items()}}

    def load_state_dict(self, sd: dict) -> None:
        if set(sd["opts"]) != set(self.opts):
            raise ValueError(f"optimizer states for {sorted(sd['opts'])}, "
                             f"this stage trains {sorted(self.opts)}")
        for k, o in self.opts.items():
            o.load_state_dict(sd["opts"][k])
        for k, s in self.scheds.items():
            s.load_state_dict(sd["scheds"][k])
        self.step = int(sd["step"])


def sample_reference_curriculum(
    rng: np.random.RandomState, max_refs: int = 4
) -> Tuple[np.ndarray, int]:
    """The reference's 1..4-reference curriculum: pick k refs w.p. 1/4 each
    and one propagation source among them. Returns (ref_mask (N,), prosrc)."""
    r = rng.random_sample()
    k = min(int(r * 4) + 1, max_refs)
    chosen = rng.choice(max_refs, k, replace=False)
    prosrc = int(chosen[rng.choice(k)])
    mask = np.zeros((max_refs,), np.float32)
    mask[chosen] = 1.0
    return mask, prosrc


def apply_curriculum(
    batch: Dict[str, np.ndarray], stage: int, rng: np.random.RandomState,
    max_refs: int = 4,
) -> Dict[str, np.ndarray]:
    """The host-side reference curriculum on a stacked raw batch: stage 1
    keeps every reference; stage 2 masks a random 1..4 subset
    (``train/2:155-163``); stages 3/4 also promote a random chosen
    reference's image/cam/verts to ``prev_*`` and drop the per-reference
    source arrays (``train/4:249-267``)."""
    B = batch["src_parts"].shape[0]
    if stage == 1:
        batch.setdefault("ref_mask", np.ones((B, max_refs), np.float32))
        return batch
    masks, prosrcs = zip(*[sample_reference_curriculum(rng, max_refs)
                           for _ in range(B)])
    batch["ref_mask"] = np.stack(masks).astype(np.float32)
    if stage >= 3 and "src_imgs" in batch:
        pr = np.asarray(prosrcs)
        ar = np.arange(B)
        batch["prev_img"] = np.ascontiguousarray(batch["src_imgs"][ar, pr])
        batch["prev_cam"] = np.ascontiguousarray(batch["src_cams"][ar, pr])
        batch["prev_verts"] = np.ascontiguousarray(
            batch["src_verts"][ar, pr])
        for k in ("src_imgs", "src_cams", "src_verts", "src_frame_indices"):
            batch.pop(k, None)
    return batch


def normalize_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Expand uint8 wire-format fields to their float semantics
    (symmetric (-1, 1) images, (0, 1) masks, raw 0..255 IUV codes) and
    derive ``tgt_iuv`` from ``tgt_iuv255`` when absent; float fields pass
    through, so every step takes both formats."""
    out = dict(batch)
    for k, v in batch.items():
        if v.dtype != torch.uint8:
            continue
        f = v.float()
        if k in U8_SYMMETRIC_FIELDS:
            out[k] = f / 255.0 * 2.0 - 1.0
        elif k in U8_UNIT_FIELDS:
            out[k] = f / 255.0
        else:  # raw codes and unknown fields: value-preserving cast
            out[k] = f
    if "tgt_iuv" not in out and "tgt_iuv255" in out:
        out["tgt_iuv"] = (out["tgt_iuv255"] / 255.0 - 0.5) * 2.0
    return out


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# synthetic data (tests and card runs without the DanceVideo dataset)
# ---------------------------------------------------------------------------

def synthetic_quad_mesh(n: int = 8, z: float = 2.0):
    """A planar grid mesh facing the camera: (verts (V, 3), faces (F, 3))."""
    ys, xs = np.meshgrid(np.linspace(-0.6, 0.6, n), np.linspace(-0.4, 0.4, n),
                         indexing="ij")
    verts = np.stack([xs, ys, np.full_like(xs, z)], -1).reshape(-1, 3)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b = i * n + j, i * n + j + 1
            c, d = (i + 1) * n + j, (i + 1) * n + j + 1
            faces.append([a, c, b])
            faces.append([b, c, d])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def synthetic_batch(
    rng: np.random.RandomState,
    batch: int = 1,
    num_refs: int = 4,
    num_parts: int = 24,
    part_size: int = 32,
    image_size: int = 64,
    num_verts: int = 64,
    num_targets: int = 1,
) -> Dict[str, np.ndarray]:
    """Random arrays with the stage-4 batch contract's shapes and ranges."""
    B, N, P, p, S = batch, num_refs, num_parts, part_size, image_size
    iuv = np.zeros((B, S, S, 3), np.float32)
    iuv[..., 0] = rng.randint(0, num_parts + 1, size=(B, S, S))
    iuv[..., 1:] = rng.randint(0, 256, size=(B, S, S, 2))
    return {
        "src_parts": rng.uniform(-1, 1, (B, N, P, p, p, 3)).astype(np.float32),
        "src_mask_parts": (rng.rand(B, N, P, p, p) > 0.5).astype(np.float32),
        "tgt_parts": rng.uniform(-1, 1, (B, num_targets, P, p, p, 3)).astype(np.float32),
        "tgt_mask_parts": (rng.rand(B, num_targets, P, p, p) > 0.5).astype(np.float32),
        "tgt_iuv255": iuv,
        "tgt_iuv": (iuv / 255.0 - 0.5) * 2.0,
        "tgt_img": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "src_img_first": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "bg_incomplete": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "prev_img": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        "smpl_mask": (rng.rand(B, S, S, 1) > 0.3).astype(np.float32),
        "face_bbox": np.tile(
            np.asarray([S // 4, 3 * S // 4, S // 8, S // 2], np.float32),
            (B, 1)),
        "prev_cam": np.tile(np.asarray([1.0, 0, 0], np.float32), (B, 1)),
        "tgt_cam": np.tile(np.asarray([1.0, 0, 0], np.float32), (B, 1)),
        "prev_verts": rng.uniform(-0.5, 0.5, (B, num_verts, 3)).astype(np.float32)
        + np.asarray([0, 0, 2.0], np.float32),
        "tgt_verts": rng.uniform(-0.5, 0.5, (B, num_verts, 3)).astype(np.float32)
        + np.asarray([0, 0, 2.0], np.float32),
        "ref_mask": np.ones((B, N), np.float32),
        "prosrc": np.zeros((B,), np.int32),
    }
