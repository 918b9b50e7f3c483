"""JAX (flax) variables <-> the port's ``state_dict``s.

A flax tree (nested dicts of arrays, one subtree per submodule) maps onto
a port module by path, because the port names its children as flax names
them. Each leaf is converted by the type of the port submodule it lands
in, never by its rank:
- ``nn.Conv`` -> ``nn.Conv2d``: kernel (k, k, cin, cout) -> weight OIHW;
- ``PartConv`` (P, k, k, cin, cout) -> the grouped (P*cout, cin, k, k),
  part-major;
- ``nn.ConvTranspose`` (``transpose_kernel=False``) -> ``nn.ConvTranspose2d``:
  flax correlates the stride-dilated input with its (k, k, cin, cout)
  kernel as it is, torch with its (cin, cout, k, k) weight flipped in
  space, so the weight is the kernel flipped and moved to (cin, cout);
- ``nn.BatchNorm`` -> ``nn.BatchNorm2d``: params scale / bias -> weight /
  bias, ``batch_stats`` mean / var -> running_mean / running_var;
- ``nn.Dense`` -> ``nn.Linear``: kernel (in, out) -> weight (out, in).
Other leaves (norm affines, HMR's ``mean_theta``, LPIPS's heads
``lin0..lin4``) keep their names. ``flax_from_state_dict`` undoes every
rule, so what the port trains loads into the JAX package. The body
modules load by the same rules: HMR (convs, its batch norms'
``batch_stats``, ``mean_theta``, the dense layers), LPIPS (the VGG16
stack and its heads) and ``VGG19Taps``, whose names are VGG19Features'.
So does the FlowNet family: FlowNet2 nests its five nets by path
(``flownetc``, ``flownets_1``, ``flownets_2``, ``flownets_d``,
``flownetfusion``), FlowNetS's bias-free ``up_flow*`` transposed convs
have no bias leaf, and its batch norms' ``batch_stats`` follow the
batch-norm rule. Two layouts of the ablation zoo have rules of their own:
- flax ``nn.SpectralNorm`` keeps its state in ``batch_stats`` under
  ``"<layer>/kernel/u"`` and ``"<layer>/kernel/sigma"``, the port's
  ``SpectralNorm`` as buffers ``u`` and ``sigma``;
- below a module marked by ``models.common.mark_vmapped`` (the port of an
  ``nn.vmap`` over P parts), each flax leaf stacks P parts' leaves on a
  leading axis, and the port's grouped leaf is the P converted leaves
  concatenated on axis 0 (a ``PartConv(parts=1)`` part keeps its axis of
  1 in flax).
Takes and gives plain numpy arrays, so it imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from jafpro_tpu_torch.models.common import SpectralNorm
from jafpro_tpu_torch.models.parts import PartConv

# the generation modules of ``JAFProPipeline``, under the param tree's names
MODULES = ("accu", "inpaint", "bg", "refine", "pro")
# every module of the param tree: the generation modules, the image and
# face discriminators and the frozen VGG19 of the perceptual loss
ALL_MODULES = MODULES + ("D", "FD", "vgg")

_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


def _kernel_to_weight(mod: nn.Module, a: np.ndarray) -> np.ndarray:
    """One flax kernel as ``mod``'s weight (PartConv's rule aside)."""
    if isinstance(mod, nn.ConvTranspose2d):
        return np.flip(a, (0, 1)).transpose(2, 3, 0, 1)
    if isinstance(mod, nn.Conv2d):
        return a.transpose(3, 2, 0, 1)
    if isinstance(mod, nn.Linear):
        return a.T
    raise TypeError(f"no kernel rule for {type(mod).__name__}")


def _weight_to_kernel(mod: nn.Module, a: np.ndarray) -> np.ndarray:
    """Undoes ``_kernel_to_weight``."""
    if isinstance(mod, nn.ConvTranspose2d):
        return np.flip(a.transpose(2, 3, 0, 1), (0, 1))
    if isinstance(mod, nn.Conv2d):
        return a.transpose(2, 3, 1, 0)
    if isinstance(mod, nn.Linear):
        return a.T
    raise TypeError(f"no weight rule for {type(mod).__name__}")


def _convert(mod: nn.Module, leaf: str, a: np.ndarray):
    """(state_dict leaf name, array) for flax leaf ``leaf`` of ``mod``."""
    if isinstance(mod, nn.BatchNorm2d):
        return _BN_NAMES[leaf], a
    if isinstance(mod, SpectralNorm):
        layer, name = leaf.rsplit("/kernel/", 1)
        if layer != mod.layer_name:
            raise KeyError(f"spectral-norm state {leaf!r} of another layer")
        return name, a
    P = getattr(mod, "flax_vmap", 0)
    if P:
        if a.shape[0] != P:
            raise ValueError(f"{leaf}: {a.shape} is not stacked over {P}")
        if leaf != "kernel":
            return leaf, a.reshape(-1)
        return "weight", np.concatenate([
            _kernel_to_weight(mod, k[0] if mod.flax_part_axis else k)
            for k in a])
    if leaf != "kernel":
        return leaf, a
    if isinstance(mod, PartConv):
        P, kh, kw, cin, cout = a.shape
        return "weight", a.transpose(0, 4, 3, 1, 2).reshape(
            P * cout, cin, kh, kw)
    return "weight", _kernel_to_weight(mod, a)


def _invert(mod: nn.Module, name: str, a: np.ndarray):
    """(collection, flax leaf name, array) for ``state_dict`` leaf ``name``
    of ``mod``; None for a buffer flax does not keep. Undoes ``_convert``."""
    if isinstance(mod, nn.BatchNorm2d):
        if name == "num_batches_tracked":
            return None
        leaf = {v: k for k, v in _BN_NAMES.items()}[name]
        return ("batch_stats" if leaf in ("mean", "var") else "params",
                leaf, a)
    if isinstance(mod, SpectralNorm):
        return "batch_stats", f"{mod.layer_name}/kernel/{name}", a
    P = getattr(mod, "flax_vmap", 0)
    if P:
        if name != "weight":
            return "params", name, a.reshape(P, -1)
        ks = [_weight_to_kernel(mod, w) for w in np.split(a, P)]
        return "params", "kernel", np.stack(
            [k[None] if mod.flax_part_axis else k for k in ks])
    if name != "weight":
        return "params", name, a
    if isinstance(mod, PartConv):
        Pc, cin, kh, kw = a.shape
        P = mod.parts
        return "params", "kernel", a.reshape(P, Pc // P, cin, kh, kw).transpose(
            0, 3, 4, 2, 1)
    return "params", "kernel", _weight_to_kernel(mod, a)


def flax_tree(module: nn.Module,
              named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors named as ``module``'s ``state_dict`` names them (all of it,
    or any part, such as optimizer moments keyed by parameter name) as
    flax variables (``{"params": ..., "batch_stats": ...}``), float32
    numpy leaves."""
    out: Dict[str, Any] = {}
    for key, t in named.items():
        *path, name = key.split(".")
        mod = module.get_submodule(".".join(path))
        got = _invert(mod, name, t.detach().float().cpu().numpy())
        if got is None:
            continue
        coll, leaf, a = got
        node = out.setdefault(coll, {})
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.array(a, dtype=np.float32, order="C")
    return out


def flax_from_state_dict(module: nn.Module) -> Dict[str, Any]:
    """``module``'s parameters and buffers as flax variables
    (``{"params": ..., "batch_stats": ...}``, the latter only where the
    module has batch norms), float32 numpy leaves."""
    return flax_tree(module, module.state_dict())


def state_dict_from_flax(variables: Dict[str, Any],
                         module: nn.Module) -> Dict[str, torch.Tensor]:
    """Flatten one module's flax variables (``{"params": ...,
    "batch_stats": ...}`` or a bare params tree) into ``module``'s
    ``state_dict``."""
    if set(variables) <= {"params", "batch_stats"}:
        trees = [variables.get("params", {}), variables.get("batch_stats", {})]
    else:
        trees = [variables]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            mod = module.get_submodule(".".join(path))
            name, a = _convert(mod, k, np.asarray(v, dtype=np.float32))
            out[".".join(path + [name])] = torch.from_numpy(
                np.array(a, dtype=np.float32, order="C"))

    for tree in trees:
        walk(tree, [])
    # flax keeps no batch counter; eval-mode BatchNorm does not read it
    for name, mod in module.named_modules():
        if isinstance(mod, nn.BatchNorm2d) and mod.track_running_stats:
            out[f"{name}.num_batches_tracked" if name else
                "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def load_flax(module: nn.Module, variables: Dict[str, Any]) -> None:
    """Load flax variables into ``module`` (strict: every parameter and
    buffer must be present with its shape)."""
    module.load_state_dict(state_dict_from_flax(variables, module),
                           strict=True)


def load_jax_params(pipe: torch.nn.Module, params: Dict[str, Any],
                    modules=MODULES) -> None:
    """Load ``modules`` of ``pipe`` (by default the five generation
    modules; ``ALL_MODULES`` adds D, FD and vgg) from a JAX param tree
    (``JAFProPipeline.init_params`` layout)."""
    for name in modules:
        load_flax(getattr(pipe, name), params[name])


def jax_params(pipe: torch.nn.Module, modules=ALL_MODULES) -> Dict[str, Any]:
    """``modules`` of ``pipe`` as a JAX param tree (the inverse of
    ``load_jax_params``)."""
    return {name: flax_from_state_dict(getattr(pipe, name))
            for name in modules}
