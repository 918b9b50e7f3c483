"""HMR: Human Mesh Recovery regressor (port of ``jafpro_tpu/models/hmr.py``).

PreActResNet50-v2 encoder (the TF-style pre-activation bottleneck with
biased 1x1 ``conv3`` / ``shortcut``, stride 2 on the LAST block of each
layer) and an iterative 3-step ``ThetaRegressor`` giving the 85-dim
theta = [cam (3), pose (72), shape (10)]. NCHW: an image batch is
(B, 3, H, W), the JAX package's (B, H, W, 3) permuted. Batch norms run
with their running statistics (``eval()``) and flax's epsilon, or in
``train()`` with the batch's, moving the running ones as flax does
(``FlaxBatchNorm2d``); children carry the flax names, so
``bridge.load_flax`` loads a JAX tree (``batch_stats`` included).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.geometry.projection import orthographic_proj_withz_idrot
from jafpro_tpu_torch.models.common import (
    Conv2d, FlaxBatchNorm2d, Linear, _truncated_normal_, init_params_)

BN_EPS = 1e-5        # flax nn.BatchNorm's epsilon
BN_MOMENTUM = 0.01   # flax's 0.99 decay of the running statistics


def _bn(c: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class _PreActBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 compute_dtype=None):
        super().__init__()
        out_planes = self.expansion * planes
        self.stride = stride
        self.bn1 = _bn(in_planes)
        if in_planes != out_planes:
            self.shortcut = Conv2d(in_planes, out_planes, 1, stride,
                                   compute_dtype=compute_dtype)
        self.conv1 = Conv2d(in_planes, planes, 1, bias=False,
                            compute_dtype=compute_dtype)
        self.bn2 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False,
                            compute_dtype=compute_dtype)
        self.bn3 = _bn(planes)
        self.conv3 = Conv2d(planes, out_planes, 1,
                            compute_dtype=compute_dtype)

    @staticmethod
    def _norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
        # float32 out, as flax's norm promotes the input to its params' type
        return F.relu(bn(x.float()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        preact = self._norm(self.bn1, x)
        if hasattr(self, "shortcut"):
            shortcut = self.shortcut(preact)
        elif self.stride != 1:
            # a 1x1 max pool with stride: a strided slice
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = x
        y = self._norm(self.bn2, self.conv1(preact))
        y = self._norm(self.bn3, self.conv2(y))
        y = self.conv3(y)
        return y + shortcut


class PreActResNet50(nn.Module):
    """Stem (7x7/2 conv, 3x3/2 max pool), 4 layers of bottlenecks, post
    BN + ReLU, global average pool: (B, 3, H, W) -> (B, 2048)."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 compute_dtype=None):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, compute_dtype=compute_dtype)
        cin = 64
        for li, (p, n, s) in enumerate(zip((64, 128, 256, 512),
                                           self.num_blocks, (2, 2, 2, 1))):
            for bi in range(n):
                self.add_module(f"layer{li + 1}_{bi}", _PreActBottleneck(
                    cin, p, s if bi == n - 1 else 1, compute_dtype))
                cin = 4 * p
        self.post_bn = _bn(cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        # max_pool(k3, s2) over a -inf pad of one row and column at the
        # bottom and right (torch's ceil_mode=True windows)
        x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=-math.inf), 3, 2)
        for li, n in enumerate(self.num_blocks):
            for bi in range(n):
                x = getattr(self, f"layer{li + 1}_{bi}")(x)
        return F.relu(self.post_bn(x.float())).mean(dim=(2, 3))


class ThetaRegressor(nn.Module):
    """Iterative residual regression of theta from ``[features, theta]``."""

    def __init__(self, feature_dim: int = 2048, theta_dim: int = 85,
                 iterations: int = 3, compute_dtype=None):
        super().__init__()
        self.iterations = iterations
        self.mean_theta = nn.Parameter(torch.zeros(theta_dim))
        self.fc1 = Linear(feature_dim + theta_dim, 1024,
                          compute_dtype=compute_dtype)
        self.fc2 = Linear(1024, 1024, compute_dtype=compute_dtype)
        self.fc3 = Linear(1024, theta_dim, compute_dtype=compute_dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        theta = self.mean_theta.expand(features.shape[0], -1)
        for _ in range(self.iterations):
            h = torch.cat([features, theta], dim=1)
            h = F.relu(self.fc1(h))
            h = F.relu(self.fc2(h))
            theta = theta + self.fc3(h)
        return theta


class HumanModelRecovery(nn.Module):
    """image (B, 3, 224, 224) -> theta (B, 85). Built on ``device`` (the
    card unless the caller asks for the CPU) with flax's initialisers drawn
    from ``generator``; ``eval()`` mode."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 compute_dtype: Optional[torch.dtype] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resnet = PreActResNet50(num_blocks, compute_dtype)
        self.regressor = ThetaRegressor(compute_dtype=compute_dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params_(self, generator)
        with torch.no_grad():
            self.regressor.mean_theta.copy_(torch.rand(
                self.regressor.mean_theta.shape, generator=generator))
            # fc3: variance_scaling(0.01, "fan_avg", "truncated_normal")
            w = self.regressor.fc3.weight
            _truncated_normal_(w, math.sqrt(0.01 / ((w.shape[0] + w.shape[1])
                                                    / 2)) / 0.87962566103423978,
                               generator)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.regressor(self.resnet(x))


def get_details(smpl_model, theta: torch.Tensor) -> dict:
    """Split theta and run SMPL: cam, pose, shape, verts, j2d (the
    weak-perspective projection of the joints) and j3d."""
    cam, pose, shape = theta[:, 0:3], theta[:, 3:75], theta[:, 75:]
    verts, j3d, _ = smpl_model(shape, pose, get_skin=True)
    j2d = orthographic_proj_withz_idrot(j3d, cam)[..., :2]
    return {"theta": theta, "cam": cam, "pose": pose, "shape": shape,
            "verts": verts, "j2d": j2d, "j3d": j3d}
