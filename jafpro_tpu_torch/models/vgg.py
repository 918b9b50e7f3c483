"""VGG19 perceptual feature extractor (port of ``jafpro_tpu/models/vgg.py``).

``VGG19_CRN`` (reference ``src/crn_model.py:40-65``): torchvision's VGG19
conv stack with the max pools replaced by 2x2 average pools, returning the
pre-ReLU outputs of conv1_2, conv2_2, conv3_2, conv4_2 and conv5_2. NCHW.
Children carry the flax names (``conv1_1`` ...), so a flax tree loads
through ``bridge.load_flax``; ``load_torch_vgg19`` maps a torchvision
checkpoint onto the same names. ``compute_dtype`` is flax's ``dtype``
(None: the input's dtype).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.models.common import Conv2d

# torchvision cfg 'E' conv channels per block
_BLOCKS = ((64, 64), (128, 128), (256, 256, 256, 256),
           (512, 512, 512, 512), (512, 512, 512, 512))
# the convs' indices in torchvision's ``vgg19().features``
_TORCHVISION_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32,
                    34)


def _conv_names() -> List[str]:
    return [f"conv{b + 1}_{i + 1}" for b, ws in enumerate(_BLOCKS)
            for i in range(len(ws))]


class VGG19Features(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        cin = 3
        for b, widths in enumerate(_BLOCKS):
            for i, w in enumerate(widths):
                self.add_module(f"conv{b + 1}_{i + 1}", Conv2d(
                    cin, w, 3, padding=1, compute_dtype=compute_dtype))
                cin = w

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, 3, H, W), Caffe-preprocessed (``losses.vgg_preprocess``).
        Returns the 5 feature maps."""
        feats = []
        for b, widths in enumerate(_BLOCKS):
            for i in range(len(widths)):
                x = getattr(self, f"conv{b + 1}_{i + 1}")(x)
                if i == 1:  # pre-ReLU convN_2 output
                    feats.append(x)
                x = F.relu(x)
            x = F.avg_pool2d(x, 2, 2)
        return feats


def load_torch_vgg19(path: str) -> Dict[str, torch.Tensor]:
    """torchvision vgg19 weights (a ``state_dict`` file, keys
    ``features.<i>.weight`` or ``<i>.weight``) -> ``VGG19Features``'s
    ``state_dict``."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out = {}
    for idx, name in zip(_TORCHVISION_IDX, _conv_names()):
        for prefix in (f"features.{idx}", f"{idx}"):
            if f"{prefix}.weight" in sd:
                out[f"{name}.weight"] = sd[f"{prefix}.weight"].float()
                out[f"{name}.bias"] = sd[f"{prefix}.bias"].float()
                break
        else:
            raise KeyError(f"missing {name} in state dict")
    return out
