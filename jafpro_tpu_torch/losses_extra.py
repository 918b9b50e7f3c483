"""The reference's losses off the main training path
(port of ``jafpro_tpu/losses_extra.py``).

Images are NCHW, the JAX package's NHWC permuted; a ``feats_fn`` maps an
NCHW batch to a list of NCHW feature maps. Reference citations:
  * VidLoss / MaskedL1Loss              src/losses.py:10-41
  * TruncVgg19 / PVGGLoss[NoNorm]       src/losses.py:43-117
  * vid2vid VGGLoss / Vgg19             src/losses.py:119-171
  * liquid HMRLoss                      src/liquid_networks.py:187-207
  * liquid FaceLoss                     src/liquid_networks.py:209-398
  * liquid StyleLoss (gram)             src/liquid_networks.py:399-421
  * EdgeConnect adversarial (nsgan)     src/models.py:58-160 usage
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.losses import vgg_preprocess
from jafpro_tpu_torch.models.common import Conv2d
from jafpro_tpu_torch.models.vgg import _BLOCKS
from jafpro_tpu_torch.ops.sampling import resize_bilinear, resize_nearest


class VGG19Taps(nn.Module):
    """The torchvision VGG19 conv stack with chosen feature taps.

    ``taps``: (block, conv) pairs (1-based) whose post-ReLU outputs are
    returned, in order. ``pool``: "avg" (TruncVgg19) or "max" (vid2vid
    ``Vgg19``). Only the blocks up to the deepest tap exist; their names
    are ``models.vgg.VGG19Features``', so those blocks' subtrees of a
    VGG19 tree load with ``bridge.load_flax``."""

    def __init__(self, taps: Sequence[tuple], pool: str = "avg",
                 compute_dtype=None):
        super().__init__()
        if pool not in ("avg", "max"):
            raise ValueError(f"unknown pool: {pool}")
        self.taps = [tuple(t) for t in taps]
        self.pool = pool
        self.deepest = max(b for b, _ in self.taps)
        cin = 3
        for b, widths in enumerate(_BLOCKS[:self.deepest]):
            for i, w in enumerate(widths):
                self.add_module(f"conv{b + 1}_{i + 1}", Conv2d(
                    cin, w, 3, padding=1, compute_dtype=compute_dtype))
                cin = w

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        want = set(self.taps)
        feats = {}
        for b, widths in enumerate(_BLOCKS[:self.deepest]):
            for i in range(len(widths)):
                x = F.relu(getattr(self, f"conv{b + 1}_{i + 1}")(x))
                if (b + 1, i + 1) in want:
                    feats[(b + 1, i + 1)] = x
            if b + 1 < self.deepest:
                x = (F.avg_pool2d if self.pool == "avg" else F.max_pool2d)(
                    x, 2, 2)
        return [feats[t] for t in self.taps]


# TruncVgg19's 12 extracted layers = post-ReLU conv1_1 .. conv4_4
TRUNC_VGG_TAPS = tuple(
    (b, i) for b, n in ((1, 2), (2, 2), (3, 4), (4, 4)) for i in range(1, n + 1))
# vid2vid Vgg19 slice outputs = relu{1..5}_1
VID2VID_VGG_TAPS = ((1, 1), (2, 1), (3, 1), (4, 1), (5, 1))
VID2VID_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def _vgg_preprocess_nchw(x: torch.Tensor) -> torch.Tensor:
    return vgg_preprocess(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def vid_loss(x_seq: torch.Tensor, y_seq: torch.Tensor,
             loss_func: Callable, w_type: str = "linear") -> torch.Tensor:
    """Frame-weighted loss over (B, T, ...) sequences; 'linear' weights
    i*2/(T+T^2), later frames weigh more."""
    if w_type != "linear":
        raise ValueError(f"unknown weight type: {w_type}")
    T = x_seq.shape[1]
    total = 0.0
    for i in range(T):
        total = total + (i + 1) * 2.0 / (T + T * T) * loss_func(
            x_seq[:, i], y_seq[:, i])
    return total


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """L1 of mask-gated tensors (the mask broadcasts over channels), mean
    over all elements."""
    return torch.mean(torch.abs((pred - target) * mask))


def pvgg_loss(feats_fn: Callable, pred: torch.Tensor, true: torch.Tensor,
              resp_std: Sequence[torch.Tensor], reg: float = 0.1,
              n_layers: Optional[int] = None) -> torch.Tensor:
    """Per-layer L1 of TruncVgg19 features of Caffe-preprocessed images,
    divided by each channel's response std + ``reg``; ``resp_std[j]`` is
    (C_j,). The target's features are constants."""
    pf = feats_fn(_vgg_preprocess_nchw(pred))
    tf = feats_fn(_vgg_preprocess_nchw(true))
    n = n_layers if n_layers is not None else len(resp_std)
    loss = 0.0
    for j in range(n):
        std = resp_std[j].reshape(1, -1, 1, 1) + reg
        loss = loss + torch.mean(torch.abs((tf[j].detach() - pf[j]) / std))
    return loss / n


def pvgg_loss_no_norm(feats_fn: Callable, pred: torch.Tensor,
                      true: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Unnormalised, un-preprocessed ``pvgg_loss``."""
    pf, tf = feats_fn(pred), feats_fn(true)
    loss = 0.0
    for j in range(n_layers):
        loss = loss + _l1(pf[j], tf[j])
    return loss / n_layers


def vid2vid_vgg_loss(feats_fn: Callable, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Weighted L1 over the relu{1..5}_1 pyramid (a VID2VID_VGG_TAPS,
    pool='max' extractor); ``y``'s features are constants."""
    loss = 0.0
    for w, a, b in zip(VID2VID_WEIGHTS, feats_fn(x), feats_fn(y)):
        loss = loss + w * _l1(a, b.detach())
    return loss


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) gram."""
    f = x.reshape(x.shape[0], x.shape[1], -1)
    return torch.matmul(f, f.transpose(1, 2))


def style_loss(feats_fn: Callable, imgs: torch.Tensor, recon: torch.Tensor,
               weight: float = 1.0, size: int = 224) -> torch.Tensor:
    """Mean |gram difference| per feature map over the map's area, on
    inputs resized (nearest, torch's default) to ``size``."""
    a = resize_nearest(imgs, (size, size))
    b = resize_nearest(recon, (size, size))
    loss = 0.0
    for fa, fb in zip(feats_fn(a), feats_fn(b)):
        area = fa.shape[2] * fa.shape[3]
        loss = loss + _l1(gram_matrix(fa), gram_matrix(fb)) / area
    return weight * loss


def hmr_loss(hmr_fn: Callable, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """L1 between the HMR outputs (a list or tuple of tensors) of two
    image batches; the target side is detached."""
    loss = 0.0
    for a, b in zip(hmr_fn(x), hmr_fn(y)):
        loss = loss + _l1(a, b.detach())
    return loss


def face_feature_loss(feats_fn: Callable, imgs1: torch.Tensor,
                      imgs2: torch.Tensor,
                      weights: Optional[Sequence[float]] = None,
                      size: tuple = (112, 96)) -> torch.Tensor:
    """Face crops resized (bilinear, align_corners=True) to the face net's
    input size, summed UNWEIGHTED L1 over its feature pyramid (the
    reference defines weights but never applies them; pass ``weights`` to
    apply them). ``feats_fn`` is any extractor: the reference's face-net
    weights are an external asset."""
    fa = feats_fn(resize_bilinear(imgs1, size, align_corners=True))
    fb = feats_fn(resize_bilinear(imgs2, size, align_corners=True))
    if weights is None:
        weights = [1.0] * len(fa)
    loss = 0.0
    for w, a, b in zip(weights, fa, fb):
        loss = loss + w * _l1(a, b.detach())
    return loss


def nsgan_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """EdgeConnect 'nsgan' loss: BCE on sigmoid outputs, clipped to
    [1e-7, 1 - 1e-7]."""
    p = torch.clamp(pred.float(), 1e-7, 1 - 1e-7)
    t = 1.0 if target_is_real else 0.0
    return -torch.mean(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def edgeconnect_inpainting_losses(
        outputs: torch.Tensor, real: torch.Tensor, fg_mask: torch.Tensor,
        disc_fn: Callable, vgg_feats_fn: Callable) -> tuple:
    """``InpaintingModel.process``'s losses (``src/models.py:94-145``): the
    discriminator's nsgan pair and the generator's [adv*0.1,
    l1/mean(mask), perceptual*0.1, style*250] over the fg-masked output.
    ``disc_fn`` maps an image to (patch probs, feats). Returns (gen_loss,
    dis_loss, logs)."""
    dis_real, _ = disc_fn(real)
    dis_fake, _ = disc_fn(outputs.detach())
    dis_loss = (nsgan_loss(dis_real, True) + nsgan_loss(dis_fake, False)) / 2

    gen_fake, _ = disc_fn(outputs)
    gen_gan = nsgan_loss(gen_fake, True) * 0.1
    om, rm = outputs * fg_mask, real * fg_mask
    gen_l1 = _l1(om, rm) / torch.mean(fg_mask)
    gen_per = vid2vid_vgg_loss(vgg_feats_fn, om, rm) * 0.1
    gen_sty = style_loss(vgg_feats_fn, rm, om) * 250.0
    gen_loss = gen_gan + gen_l1 + gen_per + gen_sty
    logs = {"l_d2": dis_loss, "l_g2": gen_gan, "l_l1": gen_l1,
            "l_per": gen_per, "l_sty": gen_sty}
    return gen_loss, dis_loss, logs
