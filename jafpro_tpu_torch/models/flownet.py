"""The FlowNet family (port of ``jafpro_tpu/models/flownet.py``), NCHW.

- ``FlowNetSD``: the no-correlation net, also the frozen flow-consistency
  metric (reference ``test/video_evaluation.py:66, 199-202``);
- ``FlowNetC``: siamese encoders and a 441-channel cost volume at 1/8
  resolution from ``ops.correlation`` (the CUDA kernel on the card);
- ``FlowNetS``, ``FlowNetFusion`` and ``FlowNet2``, the warping-and-stacking
  composite of all four;
- ``flownet2_preprocess``, ``epe`` and ``multiscale_flow_loss``, the
  harness's loss (reference ``flownet2_pytorch/losses.py``).

``batch_norm=False`` builds a net as flownet2-pytorch builds it with
``batchNorm`` False, its default: every conv block a biased conv and its
LeakyReLU, no batch norm. The blocks' outputs then stay in
``compute_dtype``: FlowNetC's correlation runs in it, and the decoders
(``deconv*``, ``predict_flow*``) promote their input to their float32
weights, as flax promotes a layer without a ``dtype``.

Batch norm is ``FlaxBatchNorm2d``: running statistics in ``eval()``, the
batch's (and flax's update of the running ones) in ``train()``, which is
the JAX package's ``train`` flag; each net starts in ``eval()``, as that
flag defaults to False. ``train_mode=True`` returns the
flow2..flow6 pyramid. ``compute_dtype`` is flax's ``dtype``, and as there it
reaches only the ``conv`` blocks (the encoders and ``conv_redir``); batch
norm promotes to float32, so the decoders, the correlation and every flow
run in float32, as in the JAX package. Children carry the flax names
(``conv0.Conv_0``, ``conv0.BatchNorm_0``, ``deconv5.ConvTranspose_0``,
``up_flow6`` ...), so a flax tree loads through ``bridge.load_flax``; a
``ConvTranspose2d(k=4, s=2, p=1)`` is the flax ``ConvTranspose(k=4, s=2,
"SAME")``. ``load_torch_flownet_sd`` maps the published FlowNet2-SD
checkpoint onto the same names.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.models.common import Conv2d, FlaxBatchNorm2d
from jafpro_tpu_torch.ops.correlation import correlation
from jafpro_tpu_torch.ops.image import channel_norm
from jafpro_tpu_torch.ops.sampling import (
    resample2d, resize_bilinear, resize_nearest)
from jafpro_tpu_torch.utils.profiling import span


class _ConvBlock(nn.Module):
    """conv + BN + LeakyReLU(0.1) (reference ``submodules.py:conv``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, act: bool = True, norm: bool = True,
                 bias: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.act, self.norm = act, norm
        use_bias = bias if bias is not None else not norm
        self.Conv_0 = Conv2d(cin, features, kernel, stride,
                             (kernel - 1) // 2, bias=use_bias,
                             compute_dtype=compute_dtype)
        if norm:
            self.BatchNorm_0 = FlaxBatchNorm2d(features)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.norm:
            x = self.BatchNorm_0(x)
        if self.act:
            x = F.leaky_relu(x, 0.1)
        return x


def _promoted(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """``x`` in the promoted type of itself and ``layer``'s weight."""
    return x.to(torch.promote_types(x.dtype, layer.weight.dtype))


class _Deconv(nn.Module):
    """ConvTranspose(k4, s2, p1) + LeakyReLU(0.1)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, features, 4, 2, 1)

    def forward(self, x):
        return F.leaky_relu(
            self.ConvTranspose_0(_promoted(x, self.ConvTranspose_0)), 0.1)


class _PredictFlow(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, 2, 3, padding=1)

    def forward(self, x):
        return self.Conv_0(_promoted(x, self.Conv_0))


def _up_flow(bias: bool = True) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=bias)


def _add_blocks(net: nn.Module, table, compute_dtype,
                batch_norm: bool) -> None:
    for name, cin, cout, k, s in table:
        net.add_module(name, _ConvBlock(cin, cout, k, s, norm=batch_norm,
                                        compute_dtype=compute_dtype))


# name, cin, cout, kernel, stride
_SD_ENCODER = (
    ("conv0", 6, 64, 3, 1), ("conv1", 64, 64, 3, 2),
    ("conv1_1", 64, 128, 3, 1), ("conv2", 128, 128, 3, 2),
    ("conv2_1", 128, 128, 3, 1), ("conv3", 128, 256, 3, 2),
    ("conv3_1", 256, 256, 3, 1), ("conv4", 256, 512, 3, 2),
    ("conv4_1", 512, 512, 3, 1), ("conv5", 512, 512, 3, 2),
    ("conv5_1", 512, 512, 3, 1), ("conv6", 512, 1024, 3, 2),
    ("conv6_1", 1024, 1024, 3, 1))
# FlowNetS's and FlowNetC's common tail: conv4 .. conv6_1 after a 256-wide
# conv3_1
_TAIL = (("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
         ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
         ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1))
# per decoder level: the skip's channels, the deconv's width
_DECODER = ((5, 512, 512), (4, 512, 256), (3, 256, 128), (2, 128, 64))


class FlowNetSD(nn.Module):
    """Input: (B, 6, H, W) image pair, H and W multiples of 64; returns
    flow2 (B, 2, H/4, W/4), or (flow2, ..., flow6) with ``train_mode``."""

    def __init__(self, compute_dtype: Optional[torch.dtype] = None,
                 batch_norm: bool = True):
        super().__init__()
        _add_blocks(self, _SD_ENCODER, compute_dtype, batch_norm)
        self.predict_flow6 = _PredictFlow(1024)
        cin = 1024
        for lvl, skip, width in _DECODER:
            self.add_module(f"up_flow{lvl + 1}", _up_flow())
            self.add_module(f"deconv{lvl}", _Deconv(cin, width))
            cat = skip + width + 2
            self.add_module(f"inter_conv{lvl}", _ConvBlock(
                cat, width, act=False, norm=batch_norm, bias=True))
            self.add_module(f"predict_flow{lvl}", _PredictFlow(width))
            cin = cat
        self.eval()

    def forward(self, x: torch.Tensor, train_mode: bool = False):
        skips = {}
        for name, *_ in _SD_ENCODER:
            x = getattr(self, name)(x)
            skips[name] = x
        flow = self.predict_flow6(x)
        flows = [flow]
        for lvl, _, _ in _DECODER:
            up = getattr(self, f"up_flow{lvl + 1}")(flow)
            d = getattr(self, f"deconv{lvl}")(x)
            x = torch.cat([skips[f"conv{lvl}_1"], d, up], 1)
            flow = getattr(self, f"predict_flow{lvl}")(
                getattr(self, f"inter_conv{lvl}")(x))
            flows.append(flow)
        return tuple(flows[::-1]) if train_mode else flow


def _build_sc_decoder(net: nn.Module, up_bias: bool) -> None:
    """FlowNetS's and FlowNetC's decoder, flow from each concat (no inter
    convs), registered on ``net`` under the flax names."""
    net.predict_flow6 = _PredictFlow(1024)
    cin = 1024
    for lvl, skip, width in _DECODER:
        net.add_module(f"up_flow{lvl + 1}", _up_flow(up_bias))
        net.add_module(f"deconv{lvl}", _Deconv(cin, width))
        cin = skip + width + 2
        net.add_module(f"predict_flow{lvl}", _PredictFlow(cin))


def _run_sc_decoder(net: nn.Module, c6: torch.Tensor,
                    skips: Sequence[torch.Tensor], train_mode: bool):
    """``skips``: the level 5, 4, 3, 2 skip maps."""
    x, flow = c6, net.predict_flow6(c6)
    flows = [flow]
    for (lvl, _, _), skip in zip(_DECODER, skips):
        x = torch.cat([skip, getattr(net, f"deconv{lvl}")(x),
                       getattr(net, f"up_flow{lvl + 1}")(flow)], 1)
        flow = getattr(net, f"predict_flow{lvl}")(x)
        flows.append(flow)
    return tuple(flows[::-1]) if train_mode else flow


class FlowNetC(nn.Module):
    """Correlation FlowNet (reference ``networks/FlowNetC.py``): inputs two
    (B, 3, H, W) images, H and W multiples of 64; returns flow2
    (B, 2, H/4, W/4), or the pyramid with ``train_mode``."""

    MAX_DISPLACEMENT, STRIDE2 = 20, 2

    def __init__(self, compute_dtype: Optional[torch.dtype] = None,
                 batch_norm: bool = True):
        super().__init__()
        for sfx in ("a", "b"):
            _add_blocks(self, ((f"conv1{sfx}", 3, 64, 7, 2),
                               (f"conv2{sfx}", 64, 128, 5, 2),
                               (f"conv3{sfx}", 128, 256, 5, 2)),
                        compute_dtype, batch_norm)
        d = (2 * (self.MAX_DISPLACEMENT // self.STRIDE2) + 1) ** 2
        _add_blocks(self, (("conv_redir", 256, 32, 1, 1),
                           ("conv3_1", 32 + d, 256, 3, 1)) + _TAIL,
                    compute_dtype, batch_norm)
        _build_sc_decoder(self, up_bias=True)
        self.eval()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                train_mode: bool = False):
        a1 = self.conv1a(x1)
        b1 = self.conv2a(a1)
        c1 = self.conv3a(b1)
        c2 = self.conv3b(self.conv2b(self.conv1b(x2)))
        corr = F.leaky_relu(correlation(c1, c2, self.MAX_DISPLACEMENT,
                                        self.STRIDE2), 0.1)
        x = self.conv3_1(torch.cat([self.conv_redir(c1), corr], 1))
        c4 = self.conv4_1(self.conv4(x))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return _run_sc_decoder(self, c6, (c5, c4, x, b1), train_mode)


class FlowNetS(nn.Module):
    """Encoder-decoder FlowNet (reference ``networks/FlowNetS.py``) on a
    (B, ``input_channels``, H, W) stack; its ``up_flow*`` have no bias."""

    def __init__(self, input_channels: int = 12,
                 compute_dtype: Optional[torch.dtype] = None,
                 batch_norm: bool = True):
        super().__init__()
        _add_blocks(self, (("conv1", input_channels, 64, 7, 2),
                           ("conv2", 64, 128, 5, 2),
                           ("conv3", 128, 256, 5, 2),
                           ("conv3_1", 256, 256, 3, 1)) + _TAIL,
                    compute_dtype, batch_norm)
        _build_sc_decoder(self, up_bias=False)
        self.eval()

    def forward(self, x: torch.Tensor, train_mode: bool = False):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return _run_sc_decoder(self, c6, (c5, c4, c3, c2), train_mode)


class FlowNetFusion(nn.Module):
    """Shallow fusion net over the 11-channel stack of both branches'
    outputs (reference ``networks/FlowNetFusion.py``): (B, 11, H, W) ->
    (B, 2, H, W)."""

    def __init__(self, compute_dtype: Optional[torch.dtype] = None,
                 batch_norm: bool = True):
        super().__init__()
        _add_blocks(self, (("conv0", 11, 64, 3, 1), ("conv1", 64, 64, 3, 2),
                           ("conv1_1", 64, 128, 3, 1),
                           ("conv2", 128, 128, 3, 2),
                           ("conv2_1", 128, 128, 3, 1)), compute_dtype,
                    batch_norm)
        self.predict_flow2 = _PredictFlow(128)
        self.up_flow2 = _up_flow()
        self.deconv1 = _Deconv(128, 32)
        self.inter_conv1 = _ConvBlock(128 + 32 + 2, 32, act=False,
                                      norm=batch_norm, bias=True)
        self.predict_flow1 = _PredictFlow(32)
        self.up_flow1 = _up_flow()
        self.deconv0 = _Deconv(128 + 32 + 2, 16)
        self.inter_conv0 = _ConvBlock(64 + 16 + 2, 16, act=False,
                                      norm=batch_norm, bias=True)
        self.predict_flow0 = _PredictFlow(16)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        flow2 = self.predict_flow2(c2)
        cat1 = torch.cat([c1, self.deconv1(c2), self.up_flow2(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(cat1))
        cat0 = torch.cat([c0, self.deconv0(cat1), self.up_flow1(flow1)], 1)
        return self.predict_flow0(self.inter_conv0(cat0))


class FlowNet2(nn.Module):
    """The full composite (reference ``models.py:29-188``): FlowNetC, two
    warped-refinement FlowNetS passes, the FlowNetSD branch and
    FlowNetFusion, with bilinear and nearest upsampling, ``resample2d``
    warps and ``channel_norm`` error magnitudes between them. Input: (B, 6,
    H, W), two stacked normalised frames; output (B, 2, H, W). Each sub-net
    gives its finest flow (flow2), in training as in evaluation, as the
    reference takes ``[0]`` of a training pyramid.

    As the JAX package has it, the SD branch's flow is divided by
    ``div_flow`` (``jafpro_tpu/models/flownet.py:410``) where the other
    branches multiply. ``batch_norm`` reaches every sub-net.
    ``warp_padding`` is "zeros" (the JAX package's ``resample2d``) or
    "border" (flownet2-pytorch's ``resample2d_cuda``, which clamps the
    corner indices)."""

    def __init__(self, div_flow: float = 20.0,
                 compute_dtype: Optional[torch.dtype] = None,
                 batch_norm: bool = True, warp_padding: str = "zeros"):
        super().__init__()
        self.div_flow = div_flow
        self.warp_padding = warp_padding
        kw = {"compute_dtype": compute_dtype, "batch_norm": batch_norm}
        self.flownetc = FlowNetC(**kw)
        self.flownets_1 = FlowNetS(**kw)
        self.flownets_2 = FlowNetS(**kw)
        self.flownets_d = FlowNetSD(**kw)
        self.flownetfusion = FlowNetFusion(**kw)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        div = self.div_flow
        img0, img1 = x[:, :3], x[:, 3:]

        def warp(flow):
            """(img1 warped by ``flow``, |img0 - it| over channels)."""
            with span("flow2.warp", device=True, n=img1.numel()):
                warped = resample2d(img1, flow, self.warp_padding)
                return warped, channel_norm(img0 - warped)

        def refine_input(flow):
            warped, err = warp(flow)
            return torch.cat([x, warped, flow / div, err], 1)

        with span("flow2.c", device=True):
            flow_c = resize_bilinear(self.flownetc(img0, img1) * div, (H, W),
                                     align_corners=False)
        s1_in = refine_input(flow_c)
        with span("flow2.s1", device=True):
            flow_s1 = resize_bilinear(self.flownets_1(s1_in) * div, (H, W),
                                      align_corners=False)
        s2_in = refine_input(flow_s1)
        with span("flow2.s2", device=True):
            flow_s2 = resize_nearest(self.flownets_2(s2_in) * div, (H, W))
        with span("flow2.sd", device=True):
            flow_sd = resize_nearest(self.flownets_d(x) / div, (H, W))
        diff_s2 = warp(flow_s2)[1]
        diff_sd = warp(flow_sd)[1]
        with span("flow2.fusion", device=True):
            return self.flownetfusion(torch.cat(
                [img0, flow_sd, flow_s2, channel_norm(flow_sd),
                 channel_norm(flow_s2), diff_sd, diff_s2], 1))


def flownet2_preprocess(frames: torch.Tensor,
                        rgb_max: float = 255.0) -> torch.Tensor:
    """(B, 3, 2, H, W) raw frame pair -> (B, 6, H, W) mean-subtracted stack
    (reference ``models.py:120-127``; the JAX package's (B, H, W, 3, 2)
    with channels first)."""
    rgb_mean = frames.mean(dim=(2, 3, 4), keepdim=True)
    x = (frames - rgb_mean) / rgb_max
    return torch.cat([x[:, :, 0], x[:, :, 1]], 1)


def epe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """End-point error: mean L2 norm over the flow channel axis (NCHW)."""
    return torch.linalg.vector_norm(target - pred, dim=1).mean()


def multiscale_flow_loss(pyramid: Sequence[torch.Tensor],
                         target: torch.Tensor, start_scale: int = 4,
                         l_weight: float = 0.32, div_flow: float = 0.05,
                         norm: str = "L1"):
    """Weighted multi-scale flow loss (reference ``losses.py:MultiScale``):
    (loss, epe). ``pyramid``: NCHW flows at 1/4, 1/8, ... resolution;
    ``target`` (B, 2, H, W). Each scale's target is the k x k window mean
    (VALID: rows and columns past the last whole window are dropped)."""
    target = div_flow * target
    loss = epev = 0.0
    for i, p in enumerate(pyramid):
        k = start_scale * 2 ** i
        t = F.avg_pool2d(target, k, k)
        w = l_weight / 2 ** i
        if norm == "L1":
            loss = loss + w * (p - t).abs().mean()
        else:
            loss = loss + w * torch.linalg.vector_norm(p - t, dim=1).mean()
        epev = epev + w * epe(p, t)
    return loss, epev


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
    for name, *_ in _SD_ENCODER:
        out.setdefault(f"{name}.BatchNorm_0.num_batches_tracked",
                       torch.zeros((), dtype=torch.long))
    for lvl, _, _ in _DECODER:
        out.setdefault(f"inter_conv{lvl}.BatchNorm_0.num_batches_tracked",
                       torch.zeros((), dtype=torch.long))
    return out
