"""JAX param tree -> the port's ``state_dict``s.

A tree as ``jafpro_tpu``'s ``JAFProPipeline.init_params`` returns it
(nested dicts of arrays, one subtree per module) maps onto the port's
modules by path, because the port names its children as flax names
them. Kernels change layout: a conv's HWIO (k, k, cin, cout) becomes OIHW,
a part conv's (P, k, k, cin, cout) becomes the grouped (P*cout, cin, k, k),
part-major. Takes plain numpy arrays, so it imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

MODULES = ("accu", "inpaint", "bg", "refine", "pro")


def _convert_kernel(a: np.ndarray) -> np.ndarray:
    if a.ndim == 5:  # PartConv (P, kh, kw, cin, cout)
        P, kh, kw, cin, cout = a.shape
        return a.transpose(0, 4, 3, 1, 2).reshape(P * cout, cin, kh, kw)
    if a.ndim == 4:  # Conv (kh, kw, cin, cout)
        return a.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten one module's flax param tree into a ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            a = np.asarray(v, dtype=np.float32)
            if k == "kernel":
                a, k = _convert_kernel(a), "weight"
            out[".".join(path + [k])] = torch.from_numpy(
                np.array(a, dtype=np.float32, order="C"))

    walk(tree, [])
    return out


def load_jax_params(pipe: torch.nn.Module, params: Dict[str, Any]) -> None:
    """Load the five generation modules of ``pipe`` from a JAX param tree
    (strict: every parameter must be present with its shape)."""
    for name in MODULES:
        getattr(pipe, name).load_state_dict(
            state_dict_from_flax(params[name]), strict=True)
