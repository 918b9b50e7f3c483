"""Convolutional recurrences (port of ``jafpro_tpu/models/conv_lstm.py``),
NCHW, looped over T in Python.

The single-layer forms (``ConvLSTM``, ``ConvGRU`` with the ``gru`` or
``modgru`` cell) run one conv over [x, h] per step, gate order i, f, o, g
for the LSTM and r, z for the GRU; their cells sit under the names flax's
``nn.scan`` gives them (``ScanConvLSTMCell_0``, ...). The grouped form
(``GroupedConvLSTM``) runs P independent ConvLSTMs over part-major packed
channels: each gate is ``PartConv(x) + PartConv(h)``, an exact
reparameterization of one conv over [x, h]. A per-step mask freezes the
state on masked steps.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jafpro_tpu_torch.models.common import Conv2d, place
from jafpro_tpu_torch.models.parts import PartConv, part_cat

GATES = ("i", "f", "o", "g")


def _freeze(new: torch.Tensor, old: torch.Tensor,
            m: Optional[torch.Tensor]) -> torch.Tensor:
    """``new`` where the step's mask (B,) is 1, ``old`` where it is 0."""
    if m is None:
        return new
    mm = m[:, None, None, None].to(new.dtype)
    return old * (1 - mm) + new * mm


def _split(x: torch.Tensor, parts: int, n: int):
    """Per part, split packed (B, P*n*D, H, W) channels into n packed
    (B, P*D, H, W) pieces."""
    B, _, H, W = x.shape
    y = x.reshape(B, parts, n, -1, H, W)
    return [y[:, :, i].reshape(B, -1, H, W) for i in range(n)]


class ConvLSTMCell(nn.Module):
    """One step: x (B, C, H, W), state (h, c) (B, D, H, W) each ->
    (state, h)."""

    def __init__(self, cin: int, hidden_dim: int, kernel: int = 3,
                 compute_dtype=None):
        super().__init__()
        self.Conv_0 = Conv2d(cin + hidden_dim, 4 * hidden_dim, kernel,
                             padding=kernel // 2, compute_dtype=compute_dtype)

    def forward(self, state, x, m: Optional[torch.Tensor] = None):
        h_prev, c_prev = state
        i, f, o, g = torch.chunk(self.Conv_0(torch.cat([x, h_prev], 1)), 4, 1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        h, c = _freeze(h, h_prev, m), _freeze(c, c_prev, m)
        return (h, c), h


class ConvLSTM(nn.Module):
    """Single-layer ConvLSTM over xs (B, T, C, H, W), mask (B, T) ->
    (outputs (B, T, D, H, W), (h_T, c_T))."""

    def __init__(self, cin: int, hidden_dim: int, kernel: int = 3,
                 compute_dtype=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.ScanConvLSTMCell_0 = ConvLSTMCell(cin, hidden_dim, kernel,
                                               compute_dtype)
        place(self, device, generator)

    def forward(self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None):
        B, T, _, H, W = xs.shape
        h = xs.new_zeros((B, self.hidden_dim, H, W))
        state, ys = (h, torch.zeros_like(h)), []
        for t in range(T):
            state, y = self.ScanConvLSTMCell_0(
                state, xs[:, t], None if mask is None else mask[:, t])
            ys.append(y)
        return torch.stack(ys, 1), state


class ConvGRUCell(nn.Module):
    """One GRU step: reset and update gates from one conv over [x, h], the
    candidate from [x, r * h]; h = z * h_prev + (1 - z) * candidate.
    ``parts`` P > 1: P independent cells over part-major packed channels
    (``cin`` and ``hidden_dim`` per part)."""

    def __init__(self, cin: int, hidden_dim: int, kernel: int = 3,
                 compute_dtype=None, parts: int = 1):
        super().__init__()
        P, D = parts, hidden_dim
        self.parts = P
        self.Conv_0 = Conv2d(P * (cin + D), P * 2 * D, kernel,
                             padding=kernel // 2, groups=P,
                             compute_dtype=compute_dtype)
        self.Conv_1 = Conv2d(P * (cin + D), P * D, kernel,
                             padding=kernel // 2, groups=P,
                             compute_dtype=compute_dtype)

    def forward(self, h_prev, x, m: Optional[torch.Tensor] = None):
        P = self.parts
        r, z = _split(torch.sigmoid(self.Conv_0(part_cat(x, h_prev, P))),
                      P, 2)
        cand = torch.tanh(self.Conv_1(part_cat(x, r * h_prev, P)))
        h = _freeze(z * h_prev + (1 - z) * cand, h_prev, m)
        return h, h


class ModConvGRUCell(nn.Module):
    """The learned-blend GRU: one sigmoid channel from a conv over [x, h]
    blends the previous state with a candidate from x alone."""

    def __init__(self, cin: int, hidden_dim: int, kernel: int = 3,
                 compute_dtype=None, parts: int = 1):
        super().__init__()
        P, D = parts, hidden_dim
        self.parts = P
        self.Conv_0 = Conv2d(P * (cin + D), P, kernel, padding=kernel // 2,
                             groups=P, compute_dtype=compute_dtype)
        self.Conv_1 = Conv2d(P * cin, P * D, kernel, padding=kernel // 2,
                             groups=P, compute_dtype=compute_dtype)

    def forward(self, h_prev, x, m: Optional[torch.Tensor] = None):
        P = self.parts
        B, _, H, W = h_prev.shape
        blend = torch.sigmoid(self.Conv_0(part_cat(x, h_prev, P)))
        blend = blend.reshape(B, P, 1, H, W)
        cand = torch.tanh(self.Conv_1(x)).reshape(B, P, -1, H, W)
        h = (h_prev.reshape(B, P, -1, H, W) * blend
             + (1 - blend) * cand).reshape(B, -1, H, W)
        h = _freeze(h, h_prev, m)
        return h, h


_GRU_CELLS = {"gru": ConvGRUCell, "modgru": ModConvGRUCell}


class ConvGRU(nn.Module):
    """Single-layer ConvGRU (``cell`` "gru" or "modgru") over xs
    (B, T, C, H, W), mask (B, T) -> (outputs (B, T, D, H, W), h_T).
    ``parts`` P > 1 runs P independent GRUs over packed channels."""

    def __init__(self, cin: int, hidden_dim: int, kernel: int = 3,
                 cell: str = "gru", compute_dtype=None, parts: int = 1,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        cls = _GRU_CELLS[cell]
        self.hidden = parts * hidden_dim
        self.cell_name = f"Scan{cls.__name__}_0"
        self.add_module(self.cell_name, cls(cin, hidden_dim, kernel,
                                            compute_dtype, parts))
        place(self, device, generator)

    def forward(self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None):
        B, T, _, H, W = xs.shape
        cell = getattr(self, self.cell_name)
        h, ys = xs.new_zeros((B, self.hidden, H, W)), []
        for t in range(T):
            h, y = cell(h, xs[:, t], None if mask is None else mask[:, t])
            ys.append(y)
        return torch.stack(ys, 1), h


class _Cell(nn.Module):
    """One grouped-LSTM step: x (B, P*C, H, W), state (h, c)
    (B, P*D, H, W) each."""

    def __init__(self, parts: int, cin: int, hidden: int, kernel: int = 3,
                 compute_dtype=None):
        super().__init__()
        for g in GATES:
            self.add_module(f"{g}_x", PartConv(
                parts, cin, hidden, kernel=kernel,
                compute_dtype=compute_dtype))
            self.add_module(f"{g}_h", PartConv(
                parts, hidden, hidden, kernel=kernel, use_bias=False,
                compute_dtype=compute_dtype))

    def forward(self, state, x, m: Optional[torch.Tensor] = None):
        h_prev, c_prev = state

        def gate(name):
            return getattr(self, f"{name}_x")(x) + getattr(
                self, f"{name}_h")(h_prev)

        i = torch.sigmoid(gate("i"))
        f = torch.sigmoid(gate("f"))
        o = torch.sigmoid(gate("o"))
        g = torch.tanh(gate("g"))
        c = f * c_prev + i * g
        h = o * torch.tanh(c)
        return _freeze(h, h_prev, m), _freeze(c, c_prev, m)


class GroupedConvLSTM(nn.Module):
    """P independent single-layer ConvLSTMs. xs (B, T, P*C, H, W),
    mask (B, T) -> final hidden state (B, P*hidden, H, W)."""

    def __init__(self, parts: int, cin: int, hidden_dim: int, kernel: int = 3,
                 compute_dtype=None):
        super().__init__()
        self.parts = parts
        self.hidden_dim = hidden_dim
        self.Scan_Cell_0 = _Cell(parts, cin, hidden_dim, kernel,
                                 compute_dtype=compute_dtype)

    def forward(self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None):
        B, T, _, H, W = xs.shape
        h = xs.new_zeros((B, self.parts * self.hidden_dim, H, W))
        c = torch.zeros_like(h)
        for t in range(T):
            m = None if mask is None else mask[:, t]
            h, c = self.Scan_Cell_0((h, c), xs[:, t], m)
        return h
