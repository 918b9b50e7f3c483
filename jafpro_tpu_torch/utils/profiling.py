"""Timing and tracing helpers (port of ``jafpro_tpu/utils/profiling.py``):
a step timer that waits for the card's queued work, and a
``torch.profiler`` trace for TensorBoard or ``chrome://tracing``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def step_timer(sync: bool = True) -> Iterator[dict]:
    """``with step_timer() as t: ...`` -> ``t["seconds"]`` afterwards; with
    ``sync`` (and a card) it waits for the work queued on the card
    (``torch.cuda.synchronize``) before it reads the clock."""
    out = {}
    t0 = time.perf_counter()
    yield out
    if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the host and, where there is a card, its device activity
    with ``torch.profiler`` into ``log_dir`` (TensorBoard's trace handler:
    one ``*.pt.trace.json`` per run)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
