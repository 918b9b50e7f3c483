"""Body-orientation estimation and angle-based reference-frame selection
(a copy of ``jafpro_tpu/data/angles.py``, which is numpy only).

Reference semantics: ``src/computer_angle.py:4-43`` (front/back DensePose
part-area ratio -> coarse yaw angle) and the test dataset's frame picker
(``src/data.py:499-528``): n=1 -> most frontal; n=4 -> max/66%/33%/min of the
angle range; n=5 -> quartiles.
"""

from __future__ import annotations

import numpy as np

FRONT_PARTS = (2, 9, 10, 13, 14)
BACK_PARTS = (1, 7, 8, 11, 12)


def compute_angle(iuv255: np.ndarray) -> float:
    """Coarse body yaw from DensePose part areas (host-side, data prep)."""
    part = iuv255[..., 0]
    front_area = sum(float((part == p).sum()) for p in FRONT_PARTS)
    back_area = sum(float((part == p).sum()) for p in BACK_PARTS)

    ys, xs_front = np.where(part == 2)
    frontal_avg_x = float(np.average(xs_front)) if xs_front.size else np.nan
    ys, xs_back = np.where(part == 1)
    back_avg_x = float(np.average(xs_back)) if xs_back.size else frontal_avg_x
    if np.isnan(frontal_avg_x):
        frontal_avg_x = back_avg_x
    if np.isnan(frontal_avg_x):  # neither part visible
        frontal_avg_x = back_avg_x = 0.0

    if frontal_avg_x < back_avg_x:
        ratio = (front_area + 1e-4) / (back_area + 1e-4)
        angle = np.arctan(ratio) / np.pi * 180 - 90
    else:
        ratio = -(front_area + 1e-4) / (back_area + 1e-4)
        angle = np.arctan(ratio) / np.pi * 180 + 90
    if angle < -65:
        return 65.0
    return float(angle)


def select_reference_frames(angles: np.ndarray, num_refs: int) -> np.ndarray:
    """Pick reference frame indices covering the orientation range.

    The single canonical picker, matching ``src/data.py:506-527`` exactly:
    n=1 -> most frontal (min |angle|); n in (2, 3) -> [argmax, median,
    argmin][:n]; n=4 -> [argmax, 33%, 66%, argmin] of the ascending sort;
    n=5 -> [argmax, 25%, 50%, 75%, argmin].  ``dataset.select_frames_by_angle``
    is an alias of this function.
    """
    angles = np.asarray(angles)
    T = len(angles)
    order = np.argsort(angles)  # ascending
    if num_refs == 1:
        return np.array([int(np.argmin(np.abs(angles)))])
    if num_refs == 4:
        return np.array([int(np.argmax(angles)), int(order[T // 3]),
                         int(order[(2 * T) // 3]), int(np.argmin(angles))])
    if num_refs < 4:
        return np.array([int(np.argmax(angles)), int(order[T // 2]),
                         int(np.argmin(angles))])[:num_refs]
    if num_refs == 5:
        return np.array([int(np.argmax(angles)), int(order[T // 4]),
                         int(order[T // 2]), int(order[(3 * T) // 4]),
                         int(np.argmin(angles))])
    # >5 (beyond the reference's cases): evenly spaced quantiles, extremes first
    qs = np.linspace(T - 1, 0, num_refs).round().astype(int)
    return np.array([int(order[q]) for q in qs])
