"""LPIPS perceptual distance (port of ``jafpro_tpu/lpips.py``).

LPIPS-VGG: inputs shifted and scaled as the ``lpips`` package does,
VGG16 conv blocks, unit-normalised channel features, squared differences
weighted by non-negative per-channel heads, averaged over space and summed
over the 5 layers. NCHW.

``load_torch_lpips`` reads a torchvision VGG16 ``state_dict`` and the
official ``lpips`` heads (``vgg.pth``: ``lin{k}.model.1.weight``) into
this module's ``state_dict``. Without them the module keeps its seeded
random features and unit heads: self-consistent for tracking a run, NOT
comparable to published LPIPS numbers. The repository ships neither file.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.models.common import Conv2d, init_params_

_VGG16_BLOCKS = ((64, 64), (128, 128), (256, 256, 256),
                 (512, 512, 512), (512, 512, 512))
# the convs' indices in torchvision's ``vgg16().features``
_TORCHVISION_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SHIFT = (-0.030, -0.088, -0.188)   # lpips 'shift' (on [-1, 1] input)
_SCALE = (0.458, 0.448, 0.450)      # lpips 'scale'


def _conv_names() -> List[str]:
    return [f"conv{b + 1}_{i + 1}" for b, ws in enumerate(_VGG16_BLOCKS)
            for i in range(len(ws))]


class VGG16Features(nn.Module):
    """Post-ReLU outputs of the last conv in each of the 5 blocks."""

    def __init__(self, compute_dtype=None):
        super().__init__()
        cin = 3
        for b, widths in enumerate(_VGG16_BLOCKS):
            for i, w in enumerate(widths):
                self.add_module(f"conv{b + 1}_{i + 1}", Conv2d(
                    cin, w, 3, padding=1, compute_dtype=compute_dtype))
                cin = w

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for b, widths in enumerate(_VGG16_BLOCKS):
            for i in range(len(widths)):
                x = F.relu(getattr(self, f"conv{b + 1}_{i + 1}")(x))
            feats.append(x)
            x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    """x, y: (B, 3, H, W) in [-1, 1] RGB -> (B,) distances. Built on
    ``device`` (the card unless the caller asks for the CPU) with flax's
    initialisers drawn from ``generator`` and unit heads ``lin0..lin4``."""

    def __init__(self, compute_dtype=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vgg = VGG16Features(compute_dtype)
        for k, widths in enumerate(_VGG16_BLOCKS):
            setattr(self, f"lin{k}", nn.Parameter(torch.ones(widths[-1])))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params_(self, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = x.new_tensor(_SHIFT).view(1, 3, 1, 1)
        scale = x.new_tensor(_SCALE).view(1, 3, 1, 1)
        fx = self.vgg((x - shift) / scale)
        fy = self.vgg((y - shift) / scale)
        total = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{k}").abs().view(1, -1, 1, 1)
            # the official heads are non-negative 1x1 convs
            d = torch.sum(torch.square(a - b) * lin, dim=1)
            total = total + d.mean(dim=(1, 2))
        return total


def load_torch_lpips(vgg16_path: str,
                     lpips_path: str) -> Dict[str, torch.Tensor]:
    """A torchvision VGG16 ``state_dict`` file and the official lpips
    ``vgg.pth`` heads -> ``LPIPS``'s ``state_dict``."""
    sd = torch.load(vgg16_path, map_location="cpu")
    out = {}
    for idx, name in zip(_TORCHVISION_IDX, _conv_names()):
        out[f"vgg.{name}.weight"] = sd[f"features.{idx}.weight"].float()
        out[f"vgg.{name}.bias"] = sd[f"features.{idx}.bias"].float()
    heads = torch.load(lpips_path, map_location="cpu")
    for k in range(len(_VGG16_BLOCKS)):
        out[f"lin{k}"] = heads[f"lin{k}.model.1.weight"].float().reshape(-1)
    return out


def lpips_pair(model: LPIPS, pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean LPIPS over (T, H, W, 3) stacks in [0, 1] or uint8."""
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt, np.float32)
    if pred.max() > 1.5:
        pred, gt = pred / 255.0, gt / 255.0
    dev = next(model.parameters()).device

    def nchw(a):
        return torch.from_numpy(a * 2 - 1).permute(0, 3, 1, 2).to(dev)

    with torch.no_grad():
        return float(model(nchw(pred), nchw(gt)).mean())
