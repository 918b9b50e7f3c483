"""Checkpoints as ``.npz`` param trees: load weights trained with the JAX
package (its orbax checkpoints, exported by ``tools/export_jax_params.py``
where JAX is installed; the port never needs orbax or JAX), and save what
the port trains in the same layout.

An export is ``<model_save_dir>/<exp>/params_iter_<step>.npz`` holding the
``params`` tree of the checkpoint flattened with ``/``-joined keys
(``accu/params/Conv_0/kernel`` ...). The trainer writes one per save
through the inverse bridge (every module: the generation modules, D, FD
and vgg), so ``cli infer``, ``restore_latest`` and the JAX package load it
as they load an export; beside it ``train_state_iter_<step>.pt`` holds the
optimizer states and the step for ``--resume``. It writes no
``iter_<step>/`` directory, which would read as an unexported JAX
checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from jafpro_tpu_torch.bridge import ALL_MODULES, jax_params, load_jax_params

_EXPORT_RE = re.compile(r"^params_iter_(\d+)\.npz$")
_CKPT_RE = re.compile(r"^iter_(\d+)$")


def export_name(step: int) -> str:
    return f"params_iter_{step}.npz"


def train_state_name(step: int) -> str:
    return f"train_state_iter_{step}.pt"


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested param tree -> ``/``-joined keys (the export layout)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_checkpoint(ckpt_dir: str, step: int, pipe, state,
                    mesh=None) -> str:
    """Write ``params_iter_<step>.npz`` (every module of ``pipe`` as a JAX
    param tree) and ``train_state_iter_<step>.pt`` (``state.state_dict()``)
    into ``ckpt_dir``, each through a temporary name; returns the .npz
    path. With a data-parallel ``mesh`` (whose replicas are equal) rank 0
    alone writes, and every rank waits for it before going on."""
    path = os.path.join(ckpt_dir, export_name(step))
    if mesh is None or mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **flatten(jax_params(pipe)))
        os.replace(path + ".tmp", path)
        spath = os.path.join(ckpt_dir, train_state_name(step))
        torch.save(state.state_dict(), spath + ".tmp")
        os.replace(spath + ".tmp", spath)
    if mesh is not None:
        mesh.barrier()
    return path


def restore_train_state(pipe, state, ckpt_dir: str) -> Optional[int]:
    """Load the newest save in ``ckpt_dir`` (every module, the optimizer
    states and the step) for ``--resume`` (each rank of a mesh loads it
    itself); returns its step, or None when
    there is no export. Raises FileNotFoundError when the newest export
    has no optimizer state beside it (a JAX export)."""
    found = latest_export(ckpt_dir)
    if found is None:
        return None
    step, path = found
    spath = os.path.join(ckpt_dir, train_state_name(step))
    if not os.path.exists(spath):
        raise FileNotFoundError(
            f"{path} has no optimizer state beside it ({spath}); start a "
            f"new experiment with --init-from instead")
    load_jax_params(pipe, load_params_npz(path), ALL_MODULES)
    state.load_state_dict(torch.load(spath, map_location=pipe.device,
                                     weights_only=True))
    return step


def latest_export(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the newest export in ``ckpt_dir``; None if none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _EXPORT_RE.match(n))]
    if not steps:
        return None
    step = max(steps)
    return step, os.path.join(ckpt_dir, export_name(step))


def load_params_npz(path: str) -> Dict[str, Any]:
    """An export -> the nested param tree (dicts of numpy arrays)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = data[key]
    return tree


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The newest JAX checkpoint step (an ``iter_<step>`` directory) in
    ``ckpt_dir``; None if none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _CKPT_RE.match(n))
             and os.path.isdir(os.path.join(ckpt_dir, n))]
    return max(steps) if steps else None


def restore_latest(pipe, ckpt_dir: str) -> Optional[int]:
    """Load the newest export in ``ckpt_dir`` into ``pipe``'s generation
    modules (strict); returns its step, or None when the directory holds
    neither an export nor a JAX checkpoint. Raises FileNotFoundError when
    the newest JAX checkpoint has not been exported, rather than serve
    older weights."""
    found = latest_export(ckpt_dir)
    newest = latest_checkpoint_step(ckpt_dir)
    if newest is not None and (found is None or found[0] < newest):
        raise FileNotFoundError(
            f"{ckpt_dir} holds the JAX checkpoint iter_{newest} but no "
            f"{export_name(newest)}; export it where JAX is installed with "
            f"`python tools/export_jax_params.py -e "
            f"{os.path.basename(os.path.normpath(ckpt_dir))}`")
    if found is None:
        return None
    step, path = found
    load_jax_params(pipe, load_params_npz(path))
    return step
