"""Grouped ConvLSTM over packed part-major channels (port of
``jafpro_tpu/models/conv_lstm.py:166-277``).

Each gate is ``PartConv(x) + PartConv(h)`` (gate order i, f, o, g): an
exact reparameterization of one conv over [x, h]. A per-step mask freezes
the state on masked steps.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jafpro_tpu_torch.models.parts import PartConv

GATES = ("i", "f", "o", "g")


class _Cell(nn.Module):
    """One step: x (B, P*C, H, W), state (h, c) (B, P*D, H, W) each."""

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
        if m is not None:
            mm = m[:, None, None, None].to(h.dtype)
            h = h_prev * (1 - mm) + h * mm
            c = c_prev * (1 - mm) + c * mm
        return h, c


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
