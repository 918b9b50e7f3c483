"""Seeded weights, made on the device in a few large calls.

``fill(tree, seed)`` gives every parameter of a JAFPro module tree its
value from ``seed`` and its name alone: convolution and dense kernels are
truncated normals (+-2 std) with flax's lecun scale, 1 / sqrt(fan_in);
biases and norm shifts are 0; the CRN layer norms' gammas are uniform in
[0, 1); the batch-statistics norms' scales are 1. Two trees whose
parameters share names and shapes (the program's pipeline and the
reference's bundle) get equal values, on the same kind of device.
"""

from __future__ import annotations

import math
import zlib

import torch

TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to +-2


def _kind(name: str, p: torch.Tensor) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and p.ndim >= 2:
        return "kernel"
    if leaf == "gamma":
        return "gamma"
    if leaf == "scale":
        return "one"
    return "zero"


def fill(tree: torch.nn.Module, seed: int) -> None:
    """Each top-level child of ``tree`` from its own stream, so that a
    tree that holds only some of the modules gets the same values in
    them."""
    for name, child in tree.named_children():
        fill_module(child, zlib.crc32(name.encode()) * 1_000_003 + int(seed))


@torch.no_grad()
def fill_module(module: torch.nn.Module, seed: int) -> None:
    params = sorted(module.named_parameters(), key=lambda kv: kv[0])
    if not params:
        return
    dev = params[0][1].device
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 63)
    kernels = [(n, p) for n, p in params if _kind(n, p) == "kernel"]
    gammas = [(n, p) for n, p in params if _kind(n, p) == "gamma"]
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    total = sum(p.numel() for _, p in kernels)
    z = torch.empty(total, device=dev).uniform_(lo, 1.0 - lo, generator=gen)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * z - 1.0)
    off = 0
    for _, p in kernels:
        n = p.numel()
        fan_in = p[0].numel()   # (cin / groups) * k * k, or in features
        p.copy_(z[off:off + n].view_as(p) * (1.0 / math.sqrt(fan_in)
                                              / TRUNC_STD))
        off += n
    del z
    u = torch.rand(sum(p.numel() for _, p in gammas), device=dev,
                   generator=gen)
    off = 0
    for _, p in gammas:
        p.copy_(u[off:off + p.numel()].view_as(p))
        off += p.numel()
    for n, p in params:
        kind = _kind(n, p)
        if kind == "zero":
            p.zero_()
        elif kind == "one":
            p.fill_(1.0)
