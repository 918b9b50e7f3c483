"""Standalone FlowNet training harness (port of
``jafpro_tpu/train/flow_harness.py``; reference
``src/flownet2_pytorch/main.py``): FlowNetSD or FlowNetC trained with the
multi-scale flow loss, Adam at optax's defaults, batch norm in training
mode with its running statistics moved as flax moves them.

Batches are the JAX harness's: numpy NHWC pairs (B, H, W, 6) and flows
(B, H, W, 2), from ``synthetic_flow_batch`` or a
``data.flow_datasets.FlowPairSource``; the step moves them to the model's
device and to NCHW. ``compute_dtype="bfloat16"`` runs the nets' conv
blocks in bfloat16 (the reference's ``--fp16``); parameters, batch norm
and the loss stay float32. ``save_flow_state`` / ``restore_flow_state``
cover ``--resume`` with one ``.npz`` of flax-layout trees: ``params``,
``batch_stats`` and the Adam moments ``opt/mu``, ``opt/nu``,
``opt/count``. There is no CLI, as in the JAX package.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from jafpro_tpu_torch.bridge import (
    flax_from_state_dict, flax_tree, load_flax, state_dict_from_flax)
from jafpro_tpu_torch.checkpoints import flatten, load_params_npz
from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.models.common import init_params_
from jafpro_tpu_torch.models.flownet import (
    FlowNetC, FlowNetSD, multiscale_flow_loss)
from jafpro_tpu_torch.ops.sampling import resample2d
from jafpro_tpu_torch.train.common import adam

MODELS = {"sd": FlowNetSD, "c": FlowNetC}
_STATE_RE = re.compile(r"^flow_state_iter_(\d+)\.npz$")


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., "linear")`` along
    one axis (``scale_and_translate`` with the triangle kernel,
    antialiased: widened by the scale when shrinking, renormalised over the
    taps inside the input), in float32 as JAX computes them."""
    inv = 1.0 / (n_out / n_in)
    kernel_scale = np.float32(max(inv, 1.0))
    f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
         * np.float32(inv) - np.float32(0.5))
    x = np.abs(f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (f >= -0.5) & (f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_linear_nhwc(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``jax.image.resize(x, (B, size[0], size[1], C), "linear")`` of an
    NHWC float32 array, in numpy."""
    _, H, W, _ = x.shape
    wh = _linear_resize_matrix(H, size[0])
    ww = _linear_resize_matrix(W, size[1])
    return np.einsum("bhwc,hy,wx->byxc", x.astype(np.float32), wh, ww,
                     optimize=True).astype(np.float32)


def synthetic_flow_batch(rng: np.random.RandomState, batch: int = 2,
                         size: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """A random smooth flow applied to random images, drawn from ``rng``
    as the JAX harness draws them: (pairs (B, H, W, 6), flow (B, H, W, 2)),
    float32 NHWC. The second image of each pair is the first warped by
    the flow (``resample2d`` on the CPU)."""
    img = rng.rand(batch, size, size, 3).astype(np.float32)
    low = rng.randn(batch, 4, 4, 2).astype(np.float32) * 2.0
    flow = resize_linear_nhwc(low, (size, size))
    with torch.no_grad():
        warped = resample2d(torch.from_numpy(img).permute(0, 3, 1, 2),
                            torch.from_numpy(flow).permute(0, 3, 1, 2))
    warped = warped.permute(0, 2, 3, 1).numpy()
    return np.concatenate([warped, img], axis=-1), flow


def _nchw(a, dev: torch.device) -> torch.Tensor:
    """An NHWC batch (numpy or tensor) as a contiguous NCHW tensor on
    ``dev``."""
    if isinstance(a, np.ndarray):   # a copy: JAX's arrays are read-only
        a = torch.from_numpy(np.array(a, np.float32, order="C"))
    return a.to(dev).permute(0, 3, 1, 2).contiguous()


class FlowTrainState:
    """A FlowNet in training mode, its Adam and the count of steps taken.
    ``model`` holds the parameters and the batch-norm running statistics
    (flax's ``params`` and ``batch_stats``)."""

    def __init__(self, model: torch.nn.Module, lr: float):
        self.model = model.train()
        self.opt = adam(model.parameters(), lr)
        self.step = 0


def make_flow_train_step(model_name: str = "sd", lr: float = 1e-4,
                         compute_dtype: str = "float32",
                         device: Union[str, torch.device] = "cuda"
                         ) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn) of the multi-scale flow trainer, ``model_name``
    "sd" (FlowNetSD on the stacked pair) or "c" (FlowNetC on the two
    images).

    ``init_fn(generator, sample_pairs=None)`` builds the net on ``device``
    with flax's initialisers drawn from the CPU ``torch.Generator`` (the
    sample is not needed: PyTorch knows its shapes). ``step_fn(state,
    pairs, target)`` takes one Adam step in place and returns (state,
    {"loss", "epe"}) as 0-dim float32 tensors on the device."""
    if model_name not in MODELS:
        raise KeyError(f"unknown flow model {model_name!r}; one of "
                       f"{sorted(MODELS)}")
    dev = resolve_device(device)
    dtype = None if compute_dtype == "float32" else getattr(torch,
                                                            compute_dtype)

    def init_fn(generator: torch.Generator,
                sample_pairs: Optional[np.ndarray] = None
                ) -> FlowTrainState:
        model = init_params_(MODELS[model_name](dtype), generator)
        return FlowTrainState(model.to(dev), lr)

    def step_fn(state: FlowTrainState, pairs, target):
        x = _nchw(pairs, dev)
        t = _nchw(target, dev)
        model = state.model.train()
        if model_name == "sd":
            out = model(x, train_mode=True)
        else:
            out = model(x[:, :3], x[:, 3:], train_mode=True)
        loss, epev = multiscale_flow_loss(out, t)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "epe": epev.detach()}

    return init_fn, step_fn


def state_name(step: int) -> str:
    return f"flow_state_iter_{step}.npz"


def _adam_moments(state: FlowTrainState) -> Dict[str, np.ndarray]:
    named = dict(state.model.named_parameters())
    mu, nu, count = {}, {}, 0
    for name, p in named.items():
        s = state.opt.state.get(p)
        if s:
            mu[name], nu[name] = s["exp_avg"], s["exp_avg_sq"]
            count = int(s["step"])
        else:   # no step taken: optax's zero moments
            mu[name] = nu[name] = torch.zeros_like(p)
    return {"mu": flax_tree(state.model, mu)["params"],
            "nu": flax_tree(state.model, nu)["params"],
            "count": np.asarray(count, np.int32)}


def save_flow_state(ckpt_dir: str, step: int, state: FlowTrainState) -> str:
    """Write ``flow_state_iter_<step>.npz`` into ``ckpt_dir`` (through a
    temporary name): params, batch_stats and the Adam moments and count,
    as flax-layout trees. Returns its path."""
    tree = dict(flax_from_state_dict(state.model))
    tree["opt"] = _adam_moments(state)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, state_name(step))
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **flatten(tree))
    os.replace(path + ".tmp", path)
    return path


def latest_flow_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _STATE_RE.match(n))]
    return max(steps) if steps else None


def restore_flow_state(ckpt_dir: str, state: FlowTrainState
                       ) -> Tuple[FlowTrainState, int]:
    """Load the newest save in ``ckpt_dir`` into ``state`` (strict):
    (state, its step), or (state, 0) when there is none."""
    step = latest_flow_step(ckpt_dir)
    if step is None:
        return state, 0
    tree = load_params_npz(os.path.join(ckpt_dir, state_name(step)))
    model = state.model
    load_flax(model, {"params": tree["params"],
                      "batch_stats": tree.get("batch_stats", {})})
    mu = state_dict_from_flax(tree["opt"]["mu"], model)
    nu = state_dict_from_flax(tree["opt"]["nu"], model)
    count = int(tree["opt"]["count"])
    for name, p in model.named_parameters():
        state.opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    state.step = step
    return state, step
