"""Export the JAX package's newest checkpoint of an experiment to ``.npz``
for the PyTorch port.

Run where JAX (and orbax) are installed:

    python tools/export_jax_params.py -e <exp_name>

It restores the newest ``<model_save_dir>/<exp>/iter_<step>`` as ``cli
infer`` does (the raw checkpoint; ``model_save_dir`` from the JAX package's
``get_general_options``) and writes its ``params`` tree, flattened with
``/``-joined keys, to ``<model_save_dir>/<exp>/params_iter_<step>.npz``.
``jafpro_tpu_torch.checkpoints`` finds and loads that file.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def export(ckpt_dir: str) -> str:
    """Write ``ckpt_dir/params_iter_<step>.npz`` for the newest step;
    returns its path."""
    from jafpro_tpu.checkpoints import latest_step, restore_checkpoint

    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no iter_<step> checkpoint in {ckpt_dir}")
    params = restore_checkpoint(ckpt_dir, step)["params"]
    path = os.path.join(ckpt_dir, f"params_iter_{step}.npz")
    np.savez(path, **flatten(params))
    return path


def main(argv=None) -> None:
    from jafpro_tpu.config import get_general_options

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exp_name", "-e", default="exp")
    a = ap.parse_args(argv)
    root = get_general_options().model_save_dir
    print("wrote", export(os.path.join(root, a.exp_name)))


if __name__ == "__main__":
    main()
