"""Flow-propagation blend network (port of
``jafpro_tpu/models/propagation.py``), NCHW.

Predicts a per-pixel blend weight between the SMPL-flow-warped reference
frame (tsf) and the generated frame. Normalization always uses the current
batch's statistics, never running ones; ``per_sample_norm=True`` takes them
per sample over (H, W), the inference setting.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.models.common import Conv2d, ReflectConv
from jafpro_tpu_torch.ops.sampling import resize_bilinear
from jafpro_tpu_torch.parallel.mesh import active_mesh, sum_over_ranks


class BatchStatsNorm(nn.Module):
    """BatchNorm with current-batch statistics: per channel over (B, H, W),
    or over (H, W) per sample with ``per_sample=True``. Inside a
    data-parallel step (``parallel.mesh.active_mesh``) the (B, H, W)
    statistics are the global batch's: sums over every rank's equal shard,
    the variance in two passes as without a mesh."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, per_sample: bool) -> torch.Tensor:
        x32 = x.float()
        mesh = None if per_sample else active_mesh()
        if mesh is None:
            dims = (2, 3) if per_sample else (0, 2, 3)
            mean = x32.mean(dim=dims, keepdim=True)
            var = torch.square(x32 - mean).mean(dim=dims, keepdim=True)
        else:
            n = x32.numel() // x32.shape[1] * mesh.world
            mean = sum_over_ranks(
                x32.sum(dim=(0, 2, 3), keepdim=True), mesh) / n
            var = sum_over_ranks(torch.square(x32 - mean).sum(
                dim=(0, 2, 3), keepdim=True), mesh) / n
        y = (x32 - mean) / torch.sqrt(var + self.eps)
        y = y * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


class _ResnetBlock(nn.Module):
    def __init__(self, features: int, compute_dtype=None):
        super().__init__()
        self.ReflectConv_0 = ReflectConv(features, features, 3,
                                         compute_dtype=compute_dtype)
        self.BatchStatsNorm_0 = BatchStatsNorm(features)
        self.ReflectConv_1 = ReflectConv(features, features, 3,
                                         compute_dtype=compute_dtype)
        self.BatchStatsNorm_1 = BatchStatsNorm(features)

    def forward(self, x, per_sample: bool):
        y = F.relu(self.BatchStatsNorm_0(self.ReflectConv_0(x), per_sample))
        y = self.BatchStatsNorm_1(self.ReflectConv_1(y), per_sample)
        return x + y


class CompositeWeightUnet(nn.Module):
    def __init__(self, cin: int, ngf: int = 32, n_downsampling: int = 2,
                 n_blocks: int = 3, compute_dtype=None):
        super().__init__()
        self.n_downsampling = n_downsampling
        self.n_blocks = n_blocks
        cd = compute_dtype
        self.ReflectConv_0 = ReflectConv(cin, ngf, 7, compute_dtype=cd)
        self.BatchStatsNorm_0 = BatchStatsNorm(ngf)
        conv, norm = 0, 1
        c = ngf
        for i in range(n_downsampling):
            f = ngf * 2 ** i * 2
            self.add_module(f"Conv_{conv}", Conv2d(
                c, f, 3, stride=2, padding=1, compute_dtype=cd))
            self.add_module(f"BatchStatsNorm_{norm}", BatchStatsNorm(f))
            conv, norm, c = conv + 1, norm + 1, f
        for i in range(n_blocks):
            self.add_module(f"_ResnetBlock_{i}", _ResnetBlock(
                c, compute_dtype=cd))
        for i in range(n_downsampling):
            f = ngf * 2 ** (n_downsampling - i) // 2
            self.add_module(f"Conv_{conv}", Conv2d(
                c, f, 3, padding=1, compute_dtype=cd))
            self.add_module(f"BatchStatsNorm_{norm}", BatchStatsNorm(f))
            conv, norm, c = conv + 1, norm + 1, f
        self.ReflectConv_1 = ReflectConv(c, 1, 7, compute_dtype=cd)

    def forward(self, x, per_sample: bool):
        x = F.relu(self.BatchStatsNorm_0(self.ReflectConv_0(x), per_sample))
        conv, norm = 0, 1
        for _ in range(self.n_downsampling):
            x = getattr(self, f"Conv_{conv}")(x)
            x = F.relu(getattr(self, f"BatchStatsNorm_{norm}")(x, per_sample))
            conv, norm = conv + 1, norm + 1
        for i in range(self.n_blocks):
            x = getattr(self, f"_ResnetBlock_{i}")(x, per_sample)
        for _ in range(self.n_downsampling):
            H, W = x.shape[-2:]
            # nn.Upsample(scale_factor=2, mode='bilinear'): align_corners=False
            x = resize_bilinear(x, (H * 2, W * 2), align_corners=False)
            x = getattr(self, f"Conv_{conv}")(x)
            x = F.relu(getattr(self, f"BatchStatsNorm_{norm}")(x, per_sample))
            conv, norm = conv + 1, norm + 1
        return torch.sigmoid(self.ReflectConv_1(x))


class Propagation3DFlowNet(nn.Module):
    """fake_tgt (B,3,S,S), tsf_image (B,3,S,S), tgt_iuv (B,3,S,S),
    tgt_smpl_mask (B,1,S,S) -> {'pred_target', 'weight'}."""

    def __init__(self, ngf: int = 32, n_downsampling: int = 2,
                 n_blocks: int = 3, use_mask: bool = True,
                 use_iuv: bool = True, per_sample_norm: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.use_mask = use_mask
        self.use_iuv = use_iuv
        self.per_sample_norm = per_sample_norm
        self.CompositeWeightUnet_0 = CompositeWeightUnet(
            9 if use_iuv else 6, ngf, n_downsampling, n_blocks,
            compute_dtype=compute_dtype)

    def forward(self, fake_tgt, tsf_image, tgt_iuv, tgt_smpl_mask=None,
                per_sample_norm: Optional[bool] = None
                ) -> Dict[str, torch.Tensor]:
        if per_sample_norm is None:
            per_sample_norm = self.per_sample_norm
        if self.use_mask and tgt_smpl_mask is not None:
            tsf_image = tsf_image * tgt_smpl_mask
        feats = [tsf_image, fake_tgt] + ([tgt_iuv] if self.use_iuv else [])
        weight = self.CompositeWeightUnet_0(torch.cat(feats, dim=1),
                                            per_sample_norm)
        pred = fake_tgt * weight + tsf_image * (1.0 - weight)
        return {"pred_target": pred, "weight": weight}
