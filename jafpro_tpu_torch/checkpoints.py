"""Load weights trained with the JAX package (its orbax checkpoints,
exported to ``.npz`` by ``tools/export_jax_params.py`` where JAX is
installed; the port never needs orbax or JAX).

An export is ``<model_save_dir>/<exp>/params_iter_<step>.npz`` holding the
``params`` tree of the checkpoint flattened with ``/``-joined keys
(``accu/params/Conv_0/kernel`` ...).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from jafpro_tpu_torch.bridge import load_jax_params

_EXPORT_RE = re.compile(r"^params_iter_(\d+)\.npz$")
_CKPT_RE = re.compile(r"^iter_(\d+)$")


def export_name(step: int) -> str:
    return f"params_iter_{step}.npz"


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
