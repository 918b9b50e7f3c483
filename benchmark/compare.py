"""The numbers that decide ``correct``, each against the plain reference.

Served clips: for each of the four uint8 streams, the mean absolute
difference of a frame from the reference's, in uint8 steps, at the worst
frame of the sampled clips. A frame altered where it is produced moves its
own mean whole, so it is not diluted by the clip's other frames.

Training: (a) each step's losses (total, recon, G, FG, D, FD) as the
relative gap to the reference's; (b) the first gradient as the optimizer
holds it, Adam's first moment after step 1, and (c) the parameters' change
after step 3, both by the worst leaf: the gap between the program's norm
and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose reference gradient is under
a thousandth of the median leaf's are left out of (c): Adam moves them by
round-off alone.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

STREAMS = ("final", "coarse", "mask", "tsf")


def worst_frame_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """(T, S, S, C) uint8 each -> the largest per-frame mean |diff|."""
    if prog.shape != ref.shape:
        return float("inf")
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return float(d.reshape(d.shape[0], -1).mean(axis=1).max())


def clip_gaps(pairs: Sequence[tuple], streams=STREAMS) -> Dict[str, float]:
    """[(program clip, reference clip), ...] of {stream: (T, S, S, C)} ->
    {stream: worst frame's gap over the clips}."""
    out = {}
    for s in streams:
        gaps = [worst_frame_gap(p[s], r[s]) for p, r in pairs]
        out[s] = max(gaps) if gaps else float("inf")
    return out


def loss_gap(prog: List[Dict[str, float]],
             ref: List[Dict[str, float]]) -> float:
    """Worst relative gap of any loss at any step."""
    if len(prog) != len(ref):
        return float("inf")
    worst = 0.0
    for p, r in zip(prog, ref):
        for k, rv in r.items():
            pv = p.get(k, float("nan"))
            gap = abs(pv - rv) / max(abs(rv), 1e-12)
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    return worst


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool] = None) -> np.ndarray:
    """Per leaf: |‖p‖ - ‖r‖| / max(‖r‖, median leaf ‖r‖); leaves not in
    ``keep`` are nan."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if p.shape != r.shape or p.size == 0:
        return np.full((max(r.size, 1),), np.inf)
    keep = np.ones(r.shape, bool) if keep is None else np.asarray(keep, bool)
    gap = np.abs(p - r) / np.maximum(r, np.median(r[keep]))
    return np.where(keep, np.where(np.isfinite(gap), gap, np.inf), np.nan)


def moving_leaves(ref_grad_norms: Sequence[float]) -> List[bool]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    g = np.asarray(ref_grad_norms, np.float64)
    return list(g >= 1e-3 * np.median(g))
