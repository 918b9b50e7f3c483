"""The losses evaluation needs (port of part of ``jafpro_tpu/losses.py``).

  * ``vgg_preprocess`` — (-1, 1) -> 0..255 and Caffe mean subtraction,
    channel-wise in the stored order (``src/networks.py:109-115``).
  * ``vgg_feature_l1`` — VGG feature-weighted L1; ``VGG_LOSS_WEIGHTS`` are
    the training weights (``src/networks.py:118-125``), ``CRN_VGG_WEIGHTS``
    the evaluator's.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

VGG_LOSS_WEIGHTS = (1 / 2.6, 1 / 4.8, 1 / 3.7, 1 / 5.6, 10 / 1.5)
CRN_VGG_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
_CAFFE_MEANS = (103.939, 116.779, 123.68)


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def vgg_preprocess(x: torch.Tensor) -> torch.Tensor:
    """(-1, 1) channels-last -> 0..255 with Caffe mean subtraction."""
    x = 255.0 * (x + 1.0) / 2.0
    return x - x.new_tensor(_CAFFE_MEANS)


def vgg_feature_l1(
    feats_x: List[torch.Tensor],
    feats_y: List[torch.Tensor],
    weights: Sequence[float] = VGG_LOSS_WEIGHTS,
) -> torch.Tensor:
    loss = 0.0
    for w, fx, fy in zip(weights, feats_x, feats_y):
        loss = loss + w * l1(fx, fy)
    return loss
