"""Loss functions (port of ``jafpro_tpu/losses.py``).

  * ``masked_atlas_l1`` — per-target L1 over (union of source visibility)
    AND (target visibility) (``src/networks.py:1614-1639``).
  * ``vgg_preprocess`` — (-1, 1) -> 0..255 and Caffe mean subtraction,
    channel-wise in the stored order (``src/networks.py:109-115``).
  * ``vgg_feature_l1`` — VGG feature-weighted L1; ``VGG_LOSS_WEIGHTS`` are
    the training weights (``src/networks.py:118-125``), ``CRN_VGG_WEIGHTS``
    the evaluator's.
  * ``vgg_l1_loss`` — perceptual + plain L1 with the target's features
    detached (the reference's ``VGG_l1_loss``).
  * ``bce`` / ``bce_masked`` — BCE on sigmoid outputs with the JAX
    package's clipped-eps formula (``nn.BCELoss`` clamps the log at -100
    instead, which differs near 0 and 1).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from jafpro_tpu_torch.parallel.mesh import active_mesh

VGG_LOSS_WEIGHTS = (1 / 2.6, 1 / 4.8, 1 / 3.7, 1 / 5.6, 10 / 1.5)
CRN_VGG_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
_CAFFE_MEANS = (103.939, 116.779, 123.68)


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def masked_atlas_l1(pred_atlas: torch.Tensor, tgt_atlas: torch.Tensor,
                    src_masks: torch.Tensor,
                    tgt_masks: torch.Tensor) -> torch.Tensor:
    """pred/tgt atlas (B, H, W, 3); src_masks (B, N, H, W) {0,1};
    tgt_masks (B, T, H, W). Sum over targets of L1 restricted to
    (union of src masks) & (target mask)."""
    union = src_masks.amax(dim=1)
    total = 0.0
    for t in range(tgt_masks.shape[1]):
        area = (union * tgt_masks[:, t])[..., None]
        total = total + l1(area * pred_atlas, area * tgt_atlas)
    return total


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


def vgg_l1_loss(vgg, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Perceptual + plain L1 of channels-last (-1, 1) images, both on
    Caffe-preprocessed inputs; ``vgg`` maps NCHW to its feature list. The
    features of ``y`` are constants (computed without a graph)."""
    xp, yp = vgg_preprocess(x), vgg_preprocess(y)
    fx = vgg(xp.permute(0, 3, 1, 2))
    with torch.no_grad():
        fy = vgg(yp.permute(0, 3, 1, 2))
    return vgg_feature_l1(fx, fy) + l1(xp, yp)


def _bce_terms(pred: torch.Tensor, target: torch.Tensor,
               eps: float) -> torch.Tensor:
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def bce(pred: torch.Tensor, target: torch.Tensor,
        eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy on sigmoid outputs, mean over all elements."""
    return torch.mean(_bce_terms(pred, target, eps))


def bce_masked(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
               eps: float = 1e-7) -> torch.Tensor:
    """Per-sample-masked BCE: the mean over the valid samples only (the
    reference drops samples with empty face boxes, ``train/4:338-353``).
    Inside a data-parallel step it divides by the global batch's count of
    valid samples and returns this rank's share times the world size, so
    the mean over the ranks is the global value (``parallel/mesh.py``)."""
    per = _bce_terms(pred, target, eps)
    per = per.reshape(per.shape[0], -1).mean(dim=1)
    v = valid.to(per.dtype)
    mesh = active_mesh()
    if mesh is None:
        return torch.sum(per * v) / torch.clamp(torch.sum(v), min=1.0)
    count = mesh.all_reduce(valid.float().sum())
    return mesh.world * torch.sum(per * v) / torch.clamp(
        count, min=1.0).to(per.dtype)
