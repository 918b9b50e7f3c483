"""FlowNetSD (port of ``jafpro_tpu/models/flownet.py``'s FlowNetSD).

The no-correlation optical-flow net used as a frozen flow-consistency
metric (reference ``test/video_evaluation.py:66, 199-202``). NCHW, with
batch norm always on its running statistics (the frozen-metric usage).
Children carry the flax names (``conv0.Conv_0``, ``conv0.BatchNorm_0``,
``deconv5.ConvTranspose_0``, ``up_flow6`` ...), so a flax tree loads
through ``bridge.load_flax``; ``load_torch_flownet_sd`` maps the published
FlowNet2-SD checkpoint onto the same names. A ``ConvTranspose2d(k=4, s=2,
p=1)`` is the flax ``ConvTranspose(k=4, s=2, "SAME")`` of the JAX package,
whose weights are converted from the same checkpoint.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


class _ConvBlock(nn.Module):
    """conv + BN + LeakyReLU(0.1) (reference ``submodules.py:conv``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, act: bool = True, norm: bool = True,
                 bias: Optional[bool] = None):
        super().__init__()
        self.act, self.norm = act, norm
        use_bias = bias if bias is not None else not norm
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride,
                                (kernel - 1) // 2, bias=use_bias)
        if norm:
            self.BatchNorm_0 = nn.BatchNorm2d(features)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.norm:
            bn = self.BatchNorm_0
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, training=False, eps=bn.eps)
        if self.act:
            x = F.leaky_relu(x, 0.1)
        return x


class _Deconv(nn.Module):
    """ConvTranspose(k4, s2, p1) + LeakyReLU(0.1)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, features, 4, 2, 1)

    def forward(self, x):
        return F.leaky_relu(self.ConvTranspose_0(x), 0.1)


class _PredictFlow(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, 2, 3, padding=1)

    def forward(self, x):
        return self.Conv_0(x)


_ENCODER = (  # name, cin, cout, stride
    ("conv0", 6, 64, 1), ("conv1", 64, 64, 2), ("conv1_1", 64, 128, 1),
    ("conv2", 128, 128, 2), ("conv2_1", 128, 128, 1),
    ("conv3", 128, 256, 2), ("conv3_1", 256, 256, 1),
    ("conv4", 256, 512, 2), ("conv4_1", 512, 512, 1),
    ("conv5", 512, 512, 2), ("conv5_1", 512, 512, 1),
    ("conv6", 512, 1024, 2), ("conv6_1", 1024, 1024, 1))
# per decoder level: the skip's channels, the deconv's width
_DECODER = ((5, 512, 512), (4, 512, 256), (3, 256, 128), (2, 128, 64))


class FlowNetSD(nn.Module):
    """Input: (B, 6, H, W) image pair in [0, 1], H and W multiples of 64;
    returns flow2 (B, 2, H/4, W/4)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, s in _ENCODER:
            self.add_module(name, _ConvBlock(cin, cout, stride=s))
        self.predict_flow6 = _PredictFlow(1024)
        cin = 1024
        for lvl, skip, width in _DECODER:
            self.add_module(f"up_flow{lvl + 1}",
                            nn.ConvTranspose2d(2, 2, 4, 2, 1))
            self.add_module(f"deconv{lvl}", _Deconv(cin, width))
            cat = skip + width + 2
            self.add_module(f"inter_conv{lvl}", _ConvBlock(
                cat, width, act=False, bias=True))
            self.add_module(f"predict_flow{lvl}", _PredictFlow(width))
            cin = cat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = {}
        for name, _, _, _ in _ENCODER:
            x = getattr(self, name)(x)
            skips[name] = x
        flow = self.predict_flow6(x)
        for lvl, _, _ in _DECODER:
            up = getattr(self, f"up_flow{lvl + 1}")(flow)
            d = getattr(self, f"deconv{lvl}")(x)
            x = torch.cat([skips[f"conv{lvl}_1"], d, up], 1)
            flow = getattr(self, f"predict_flow{lvl}")(
                getattr(self, f"inter_conv{lvl}")(x))
        return flow


def load_torch_flownet_sd(path: str) -> Dict[str, torch.Tensor]:
    """The published FlowNet2-SD checkpoint (or any ``state_dict`` of the
    reference FlowNetSD, optionally under ``"state_dict"``) ->
    ``FlowNetSD``'s ``state_dict``. Weights keep torch's layouts."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    up_map = {f"upsampled_flow{i}_to_{i - 1}": f"up_flow{i}"
              for i in range(3, 7)}
    out = {}
    for key, v in sd.items():
        mod, *rest = key.split(".")
        if mod in up_map:                       # bare ConvTranspose
            name = f"{up_map[mod]}.{rest[-1]}"
        elif mod.startswith("predict_flow"):    # bare Conv
            name = f"{mod}.Conv_0.{rest[-1]}"
        elif mod.startswith("deconv"):          # (ConvTranspose, LeakyReLU)
            name = f"{mod}.ConvTranspose_0.{rest[-1]}"
        else:                                   # .0 = conv, .1 = batch norm
            sub = "Conv_0" if rest[0] == "0" else "BatchNorm_0"
            name = f"{mod}.{sub}.{rest[-1]}"
        out[name] = v.float() if v.is_floating_point() else v
    for name, _, _, _ in _ENCODER:
        out.setdefault(f"{name}.BatchNorm_0.num_batches_tracked",
                       torch.zeros((), dtype=torch.long))
    for lvl, _, _ in _DECODER:
        out.setdefault(f"inter_conv{lvl}.BatchNorm_0.num_batches_tracked",
                       torch.zeros((), dtype=torch.long))
    return out
