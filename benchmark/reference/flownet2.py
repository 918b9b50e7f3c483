"""FlowNet2 as flownet2-pytorch trains it by default, in plain PyTorch: the
yardstick of the ``flownet2-train-bf16`` configuration.

It follows the published network (Ilg et al., FlowNet 2.0, CVPR 2017;
https://github.com/NVIDIA/flownet2-pytorch ``models.py``,
``networks/FlowNet{C,S,SD,Fusion}.py``, ``losses.py``) with ``batchNorm``
False, its default: every conv block a biased convolution and a
LeakyReLU(0.1), no batch norm. Module and parameter names and shapes are
those of the port's FlowNet2, so one seeded set of weights loads into both
(``benchmark/weights.py``). One departure from the published network, kept
because the port has it: FlowNetC's two encoder streams (``conv1a``..
``conv3a``, ``conv1b``..``conv3b``) have their own weights where
flownet2-pytorch shares one set between the two images.

- correlation: for each of the 21 x 21 displacements (max displacement 20,
  stride 2), the channel mean of f1 times the shifted, zero-padded f2, as
  ``correlation_cuda`` with kernel size 1 and ``corr_multiply`` 1;
- ``resample2d``: an explicit bilinear gather at pixel + flow whose four
  corner indices are clamped to the image, as ``resample2d_cuda``;
- ``channel_norm``: the L2 norm over channels;
- the resizes: bilinear (align corners off) after FlowNetC and the first
  FlowNetS, nearest after the second FlowNetS and FlowNetSD;
- the loss: mean |fused - target| over (B, 2, H, W), with the EPE (mean L2
  norm of the error over the flow channels) beside it; Adam.

Float32 with TF32 off (``precision.strict_float32``), or, as the control,
with every convolution's and the correlation's operands through scaled
float8 (``precision.use("float8")``). Gradients come from autograd. It
imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import precision

MAX_DISPLACEMENT, STRIDE2 = 20, 2


class Conv(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(precision.operand(x), precision.operand(self.weight),
                        self.bias, self.stride, self.padding)


class ConvT(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(precision.operand(x),
                                  precision.operand(self.weight), self.bias,
                                  self.stride, self.padding)


class Block(nn.Module):
    """flownet2-pytorch's ``conv`` (``act``) or ``i_conv`` without batch
    norm: a biased convolution, padded to keep the size over the stride."""

    def __init__(self, cin, cout, kernel=3, stride=1, act=True):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(cin, cout, kernel, stride, (kernel - 1) // 2)

    def forward(self, x):
        y = self.Conv_0(x)
        return F.leaky_relu(y, 0.1) if self.act else y


class Deconv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.ConvTranspose_0 = ConvT(cin, cout, 4, 2, 1)

    def forward(self, x):
        return F.leaky_relu(self.ConvTranspose_0(x), 0.1)


class PredictFlow(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.Conv_0 = Conv(cin, 2, 3, 1, 1)

    def forward(self, x):
        return self.Conv_0(x)


def add_blocks(net, table):
    for name, cin, cout, k, s in table:
        net.add_module(name, Block(cin, cout, k, s))


SD_ENCODER = (
    ("conv0", 6, 64, 3, 1), ("conv1", 64, 64, 3, 2),
    ("conv1_1", 64, 128, 3, 1), ("conv2", 128, 128, 3, 2),
    ("conv2_1", 128, 128, 3, 1), ("conv3", 128, 256, 3, 2),
    ("conv3_1", 256, 256, 3, 1), ("conv4", 256, 512, 3, 2),
    ("conv4_1", 512, 512, 3, 1), ("conv5", 512, 512, 3, 2),
    ("conv5_1", 512, 512, 3, 1), ("conv6", 512, 1024, 3, 2),
    ("conv6_1", 1024, 1024, 3, 1))
TAIL = (("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
        ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
        ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1))
DECODER = ((5, 512, 512), (4, 512, 256), (3, 256, 128), (2, 128, 64))


def build_decoder(net, up_bias):
    """FlowNetS's and FlowNetC's decoder: a flow from each concat."""
    net.predict_flow6 = PredictFlow(1024)
    cin = 1024
    for lvl, skip, width in DECODER:
        net.add_module(f"up_flow{lvl + 1}", ConvT(2, 2, 4, 2, 1,
                                                  bias=up_bias))
        net.add_module(f"deconv{lvl}", Deconv(cin, width))
        cin = skip + width + 2
        net.add_module(f"predict_flow{lvl}", PredictFlow(cin))


def run_decoder(net, c6, skips):
    """flow2 from conv6_1's output and the level 5, 4, 3, 2 skips."""
    x, flow = c6, net.predict_flow6(c6)
    for (lvl, _, _), skip in zip(DECODER, skips):
        x = torch.cat([skip, getattr(net, f"deconv{lvl}")(x),
                       getattr(net, f"up_flow{lvl + 1}")(flow)], 1)
        flow = getattr(net, f"predict_flow{lvl}")(x)
    return flow


def correlation(f1, f2, md=MAX_DISPLACEMENT, s2=STRIDE2):
    """(B, C, H, W) x2 -> (B, 441, H, W), displacements dy-major."""
    _, C, H, W = f1.shape
    a = precision.operand(f1)
    f2p = F.pad(precision.operand(f2), (md, md, md, md))
    maps = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            win = f2p[:, :, md + dy:md + dy + H, md + dx:md + dx + W]
            maps.append((a * win).sum(1) / C)
    return torch.stack(maps, 1)


class FlowNetC(nn.Module):
    def __init__(self):
        super().__init__()
        for sfx in ("a", "b"):
            add_blocks(self, ((f"conv1{sfx}", 3, 64, 7, 2),
                              (f"conv2{sfx}", 64, 128, 5, 2),
                              (f"conv3{sfx}", 128, 256, 5, 2)))
        d = (2 * (MAX_DISPLACEMENT // STRIDE2) + 1) ** 2
        add_blocks(self, (("conv_redir", 256, 32, 1, 1),
                          ("conv3_1", 32 + d, 256, 3, 1)) + TAIL)
        build_decoder(self, up_bias=True)

    def forward(self, x1, x2):
        b1 = self.conv2a(self.conv1a(x1))
        c1 = self.conv3a(b1)
        c2 = self.conv3b(self.conv2b(self.conv1b(x2)))
        corr = F.leaky_relu(correlation(c1, c2), 0.1)
        x = self.conv3_1(torch.cat([self.conv_redir(c1), corr], 1))
        c4 = self.conv4_1(self.conv4(x))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return run_decoder(self, c6, (c5, c4, x, b1))


class FlowNetS(nn.Module):
    def __init__(self, input_channels=12):
        super().__init__()
        add_blocks(self, (("conv1", input_channels, 64, 7, 2),
                          ("conv2", 64, 128, 5, 2),
                          ("conv3", 128, 256, 5, 2),
                          ("conv3_1", 256, 256, 3, 1)) + TAIL)
        build_decoder(self, up_bias=False)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return run_decoder(self, c6, (c5, c4, c3, c2))


class FlowNetSD(nn.Module):
    def __init__(self):
        super().__init__()
        add_blocks(self, SD_ENCODER)
        self.predict_flow6 = PredictFlow(1024)
        cin = 1024
        for lvl, skip, width in DECODER:
            self.add_module(f"up_flow{lvl + 1}", ConvT(2, 2, 4, 2, 1))
            self.add_module(f"deconv{lvl}", Deconv(cin, width))
            cat = skip + width + 2
            self.add_module(f"inter_conv{lvl}", Block(cat, width, act=False))
            self.add_module(f"predict_flow{lvl}", PredictFlow(width))
            cin = cat

    def forward(self, x):
        skips = {}
        for name, *_ in SD_ENCODER:
            x = getattr(self, name)(x)
            skips[name] = x
        flow = self.predict_flow6(x)
        for lvl, _, _ in DECODER:
            up = getattr(self, f"up_flow{lvl + 1}")(flow)
            d = getattr(self, f"deconv{lvl}")(x)
            x = torch.cat([skips[f"conv{lvl}_1"], d, up], 1)
            flow = getattr(self, f"predict_flow{lvl}")(
                getattr(self, f"inter_conv{lvl}")(x))
        return flow


class FlowNetFusion(nn.Module):
    def __init__(self):
        super().__init__()
        add_blocks(self, (("conv0", 11, 64, 3, 1), ("conv1", 64, 64, 3, 2),
                          ("conv1_1", 64, 128, 3, 1),
                          ("conv2", 128, 128, 3, 2),
                          ("conv2_1", 128, 128, 3, 1)))
        self.predict_flow2 = PredictFlow(128)
        self.up_flow2 = ConvT(2, 2, 4, 2, 1)
        self.deconv1 = Deconv(128, 32)
        self.inter_conv1 = Block(162, 32, act=False)
        self.predict_flow1 = PredictFlow(32)
        self.up_flow1 = ConvT(2, 2, 4, 2, 1)
        self.deconv0 = Deconv(162, 16)
        self.inter_conv0 = Block(82, 16, act=False)
        self.predict_flow0 = PredictFlow(16)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        flow2 = self.predict_flow2(c2)
        cat1 = torch.cat([c1, self.deconv1(c2), self.up_flow2(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(cat1))
        cat0 = torch.cat([c0, self.deconv0(cat1), self.up_flow1(flow1)], 1)
        return self.predict_flow0(self.inter_conv0(cat0))


def resample2d(img, flow):
    """img (B, C, H, W) at p + flow(p), bilinear, corner indices clamped."""
    B, C, H, W = img.shape
    xf = torch.arange(W, dtype=flow.dtype, device=flow.device).view(
        1, 1, W) + flow[:, 0]
    yf = torch.arange(H, dtype=flow.dtype, device=flow.device).view(
        1, H, 1) + flow[:, 1]
    x0, y0 = torch.floor(xf), torch.floor(yf)
    alpha, beta = (xf - x0)[:, None], (yf - y0)[:, None]
    xl = x0.long().clamp(0, W - 1)
    xr = (x0.long() + 1).clamp(0, W - 1)
    yt = y0.long().clamp(0, H - 1)
    yb = (y0.long() + 1).clamp(0, H - 1)
    flat = img.reshape(B, C, H * W)

    def at(yi, xi):
        idx = (yi * W + xi).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(flat, 2, idx).reshape(B, C, H, W)

    return ((1 - alpha) * (1 - beta) * at(yt, xl)
            + alpha * (1 - beta) * at(yt, xr)
            + (1 - alpha) * beta * at(yb, xl)
            + alpha * beta * at(yb, xr))


def channel_norm(x):
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


class FlowNet2(nn.Module):
    """(B, 3, 2, H, W) raw frame pairs -> the fused flow (B, 2, H, W)."""

    def __init__(self, div_flow=20.0, rgb_max=255.0):
        super().__init__()
        self.div_flow, self.rgb_max = div_flow, rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, frames):
        mean = frames.mean(dim=(2, 3, 4), keepdim=True)
        x = (frames - mean) / self.rgb_max
        img0, img1 = x[:, :, 0], x[:, :, 1]
        x = torch.cat([img0, img1], 1)
        H, W = x.shape[-2:]
        div = self.div_flow

        def up(flow, mode):
            if mode == "bilinear":
                return F.interpolate(flow, (H, W), mode="bilinear",
                                     align_corners=False)
            return F.interpolate(flow, (H, W), mode="nearest")

        def refine_input(flow):
            warped = resample2d(img1, flow)
            return torch.cat([x, warped, flow / div,
                              channel_norm(img0 - warped)], 1)

        flow_c = up(self.flownetc(img0, img1) * div, "bilinear")
        flow_s1 = up(self.flownets_1(refine_input(flow_c)) * div,
                     "bilinear")
        flow_s2 = up(self.flownets_2(refine_input(flow_s1)) * div, "nearest")
        diff_s2 = channel_norm(img0 - resample2d(img1, flow_s2))
        flow_sd = up(self.flownets_d(x) / div, "nearest")
        diff_sd = channel_norm(img0 - resample2d(img1, flow_sd))
        return self.flownetfusion(torch.cat(
            [img0, flow_sd, flow_s2, channel_norm(flow_sd),
             channel_norm(flow_s2), diff_sd, diff_s2], 1))


def frames_of(pairs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 6) NHWC pairs -> (B, 3, 2, H, W) frame pairs."""
    x = pairs.permute(0, 3, 1, 2)
    return torch.stack([x[:, :3], x[:, 3:]], 2)


def l1_and_epe(fused, target):
    """flownet2-pytorch's ``L1Loss``: (L1, EPE) of (B, 2, H, W) flows."""
    return ((fused - target).abs().mean(),
            torch.linalg.vector_norm(target - fused, dim=1).mean())


class Trainer:
    """One Adam step per batch of (B, H, W, 6) raw pairs and (B, H, W, 2)
    flows, at the configuration's optimizer settings; TF32 off."""

    def __init__(self, net: FlowNet2, cfg: dict):
        precision.strict_float32()
        self.net = net
        self.opt = torch.optim.Adam(
            net.parameters(), lr=cfg["optimizer_lr"],
            betas=tuple(cfg["optimizer_betas"]), eps=cfg["optimizer_eps"],
            weight_decay=cfg["optimizer_weight_decay"])

    def step(self, pairs, target) -> Dict[str, torch.Tensor]:
        dev = next(self.net.parameters()).device
        pairs = torch.as_tensor(np.asarray(pairs, np.float32), device=dev)
        target = torch.as_tensor(np.asarray(target, np.float32),
                                 device=dev).permute(0, 3, 1, 2)
        fused = self.net(frames_of(pairs))
        loss, epe = l1_and_epe(fused, target)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return {"loss": loss.detach(), "epe": epe.detach()}
