"""The generator's and the discriminators' networks, NCHW, float32.

Module and parameter names are the port's (and through it flax's), so a
``state_dict`` of the program loads here and ``weights.fill`` fills both
trees alike. Every convolution and dense layer takes its operands through
``precision.operand``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ops import avg_pool_3x3s2, resize_bilinear
from benchmark.reference.precision import operand

ENC_NC = (12, 24, 24, 24, 24, 48, 48, 96, 96)


class Conv2d(nn.Conv2d):
    def __init__(self, cin, cout, kernel, stride=1, padding=0, bias=True,
                 groups=1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias, groups=groups)

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.conv2d(operand(x), operand(self.weight), b, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(operand(x), operand(self.weight), b)


class SampleLayerNorm(nn.Module):
    """Per-sample statistics over (C, H, W), Bessel-corrected std,
    (x - mean) / (std + eps), per-channel affine."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dims = tuple(range(1, x.ndim))
        n = math.prod(x.shape[d] for d in dims)
        mean = x.mean(dim=dims, keepdim=True)
        var = torch.square(x - mean).sum(dim=dims, keepdim=True) / (n - 1)
        y = (x - mean) / (torch.sqrt(var) + self.eps)
        return y * self.gamma.view(1, -1, 1, 1) + self.beta.view(1, -1, 1, 1)


class ConvBlock(nn.Module):
    """n x [conv 3x3, SampleLayerNorm, LeakyReLU(0.01)]."""

    def __init__(self, n_repeats, cin, features):
        super().__init__()
        self.n_repeats = n_repeats
        for i in range(n_repeats):
            self.add_module(f"Conv_{i}", Conv2d(
                cin if i == 0 else features, features, 3, padding=1))
            self.add_module(f"SampleLayerNorm_{i}", SampleLayerNorm(features))

    def forward(self, x):
        for i in range(self.n_repeats):
            x = getattr(self, f"SampleLayerNorm_{i}")(
                getattr(self, f"Conv_{i}")(x))
            x = F.leaky_relu(x, 0.01)
        return x


class ReflectConv(nn.Module):
    def __init__(self, cin, features, kernel=3):
        super().__init__()
        self.pad = kernel // 2
        self.Conv_0 = Conv2d(cin, features, kernel)

    def forward(self, x):
        p = self.pad
        return self.Conv_0(F.pad(x, (p, p, p, p), mode="reflect"))


# ---- the 24-part stacks: P independent nets as grouped convs ----------

def pack_parts(x):
    """(B, P, h, w, C) -> (B, P*C, h, w), part-major channels."""
    B, P, h, w, C = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(B, P * C, h, w)


def unpack_parts(x, parts):
    B, _, h, w = x.shape
    return x.reshape(B, parts, -1, h, w).permute(0, 1, 3, 4, 2)


class PartConv(Conv2d):
    def __init__(self, parts, cin, features, kernel=3, stride=1,
                 use_bias=True):
        super().__init__(parts * cin, parts * features, kernel, stride,
                         kernel // 2, bias=use_bias, groups=parts)


class GroupConvLReLU(nn.Module):
    """Per part: conv over the concat of the inputs (one ``PartConv_i``
    per input, the bias on the first), LeakyReLU(0.2) unless ``act`` is
    off."""

    def __init__(self, parts, cins, features, kernel=3, stride=1, act=True):
        super().__init__()
        self.act = act
        for i, cin in enumerate(cins):
            self.add_module(f"PartConv_{i}", PartConv(
                parts, cin, features, kernel, stride, use_bias=(i == 0)))
        self.n_inputs = len(cins)

    def forward(self, *inputs):
        out = sum(getattr(self, f"PartConv_{i}")(x)
                  for i, x in enumerate(inputs))
        return F.leaky_relu(out, 0.2) if self.act else out


class PartEncoder(nn.Module):
    def __init__(self, parts=24, cin=3):
        super().__init__()
        strides = (1, 2, 1, 2, 1, 2, 1, 2, 1)
        c = cin
        for i, (f, s) in enumerate(zip(ENC_NC, strides)):
            self.add_module(f"GroupConvLReLU_{i}", GroupConvLReLU(
                parts, [c], f, kernel=5 if i == 0 else 3, stride=s))
            c = f

    def forward(self, x):
        outs = []
        for i in range(9):
            x = getattr(self, f"GroupConvLReLU_{i}")(x)
            outs.append(x)
        return outs[0], outs[2], outs[4], outs[6], outs[8]


class PartDecoder(nn.Module):
    def __init__(self, parts=24, dec_nc=(48, 24, 12, 6),
                 bottleneck_cins: Sequence[int] = ()):
        super().__init__()
        skip_cs = (ENC_NC[6], ENC_NC[4], ENC_NC[2], ENC_NC[0])
        cins = [ENC_NC[8], *bottleneck_cins]
        for i, (f, cs) in enumerate(zip(dec_nc, skip_cs)):
            self.add_module(f"GroupConvLReLU_{i}", GroupConvLReLU(
                parts, [*cins, cs], f))
            cins = [f]
        self.GroupConvLReLU_4 = GroupConvLReLU(parts, [dec_nc[-1]], 3,
                                               act=False)

    def forward(self, skips, bottleneck=()):
        x1, x3, x5, x7, x9 = skips
        xs = [x9, *bottleneck]
        for i, skip in enumerate((x7, x5, x3, x1)):
            size = tuple(skip.shape[-2:])
            ups = [resize_bilinear(x, size, True) for x in xs]
            xs = [getattr(self, f"GroupConvLReLU_{i}")(*ups, skip)]
        return self.GroupConvLReLU_4(xs[0])


class _Cell(nn.Module):
    """One step of P independent ConvLSTMs; gate = conv(x) + conv(h)."""

    GATES = ("i", "f", "o", "g")

    def __init__(self, parts, cin, hidden):
        super().__init__()
        for g in self.GATES:
            self.add_module(f"{g}_x", PartConv(parts, cin, hidden))
            self.add_module(f"{g}_h", PartConv(parts, hidden, hidden,
                                               use_bias=False))

    def forward(self, h, c, x, m):
        def gate(name):
            return getattr(self, f"{name}_x")(x) + getattr(
                self, f"{name}_h")(h)

        i, f, o = (torch.sigmoid(gate(n)) for n in ("i", "f", "o"))
        c_new = f * c + i * torch.tanh(gate("g"))
        h_new = o * torch.tanh(c_new)
        m = m[:, None, None, None]
        return h * (1 - m) + h_new * m, c * (1 - m) + c_new * m


class GroupedConvLSTM(nn.Module):
    def __init__(self, parts, cin, hidden):
        super().__init__()
        self.parts, self.hidden = parts, hidden
        self.Scan_Cell_0 = _Cell(parts, cin, hidden)

    def forward(self, xs, mask):
        B, T, _, H, W = xs.shape
        h = xs.new_zeros((B, self.parts * self.hidden, H, W))
        c = torch.zeros_like(h)
        for t in range(T):
            h, c = self.Scan_Cell_0(h, c, xs[:, t], mask[:, t])
        return h


class AccumulateLSTM(nn.Module):
    """(B, N, P, h, w, 3) reference parts + (B, N) mask -> (B, P, h, w, 3)."""

    def __init__(self, parts=24):
        super().__init__()
        self.parts = parts
        self.PartEncoder_0 = PartEncoder(parts)
        for level in range(5):
            c = ENC_NC[2 * level]
            self.add_module(f"lstm{level}", GroupedConvLSTM(parts, c, c))
        self.PartDecoder_0 = PartDecoder(parts)

    def forward(self, parts, ref_mask):
        B, N, P, H, W, C = parts.shape
        skips = self.PartEncoder_0(pack_parts(parts.reshape(B * N, P, H, W,
                                                            C)))
        fused = [getattr(self, f"lstm{lv}")(s.reshape(B, N, *s.shape[1:]),
                                            ref_mask)
                 for lv, s in enumerate(skips)]
        return unpack_parts(self.PartDecoder_0(tuple(fused)), P)


class UNetInpainter(nn.Module):
    """24 per-part U-Nets sharing a global bottleneck code."""

    def __init__(self, parts=24):
        super().__init__()
        self.PartEncoder_0 = PartEncoder(parts)
        self.GroupConvLReLU_0 = GroupConvLReLU(parts, [ENC_NC[8]], 3)
        self.PartDecoder_0 = PartDecoder(parts, dec_nc=(96, 48, 24, 12),
                                         bottleneck_cins=(parts * 3,))

    def forward(self, parts):
        P = parts.shape[1]
        skips = self.PartEncoder_0(pack_parts(parts))
        code = self.GroupConvLReLU_0(skips[-1]).repeat(1, P, 1, 1)
        return unpack_parts(self.PartDecoder_0(skips, bottleneck=[code]), P)


class CRNSmaller(nn.Module):
    """Cascaded refinement network: a 6-level avg-pool encoder and a
    coarse-to-fine decoder; ``fg`` adds the sigmoid mask head."""

    ENC_REPEATS = (2, 2, 2, 2, 2, 2)
    ENC_NC = (64, 128, 128, 256, 256, 512)

    def __init__(self, fg=False, cin=3):
        super().__init__()
        self.fg = fg
        n, c = 0, cin
        for r, f in zip(self.ENC_REPEATS, self.ENC_NC):
            self.add_module(f"ConvBlock_{n}", ConvBlock(r, c, f))
            c, n = f, n + 1
        prev = 0
        for lvl in range(6, 0, -1):
            feat = 512 if lvl > 1 else 256
            self.add_module(f"ConvBlock_{n}", ConvBlock(
                2, cin + self.ENC_NC[lvl - 1] + prev, feat))
            prev, n = feat, n + 1
        self.add_module(f"ConvBlock_{n}", ConvBlock(2, cin + prev, 256))
        self.Conv_0 = Conv2d(256, 3, 1)
        if fg:
            self.Conv_1 = Conv2d(256, 1, 1)

    def forward(self, label, sp):
        pools, x = [], label
        for i in range(len(self.ENC_NC)):
            x = avg_pool_3x3s2(getattr(self, f"ConvBlock_{i}")(x))
            pools.append(x)
        net, n = None, len(self.ENC_NC)
        for lvl in range(6, 0, -1):
            size = max(1, sp // 2 ** lvl)
            down = resize_bilinear(label, (size, size), True)
            feats = [down, pools[lvl - 1]] + ([] if net is None else [net])
            x = getattr(self, f"ConvBlock_{n}")(torch.cat(feats, 1))
            n += 1
            up = max(1, sp // 2 ** (lvl - 1))
            net = resize_bilinear(x, (up, up), True)
        net = getattr(self, f"ConvBlock_{n}")(torch.cat([label, net], 1))
        out = self.Conv_0(net)
        return (out, torch.sigmoid(self.Conv_1(net))) if self.fg else out


class BatchStatsNorm(nn.Module):
    """Batch norm on the current batch's statistics: per channel over
    (B, H, W), or per sample over (H, W)."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, per_sample):
        dims = (2, 3) if per_sample else (0, 2, 3)
        mean = x.mean(dim=dims, keepdim=True)
        var = torch.square(x - mean).mean(dim=dims, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class _ResnetBlock(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.ReflectConv_0 = ReflectConv(f, f, 3)
        self.BatchStatsNorm_0 = BatchStatsNorm(f)
        self.ReflectConv_1 = ReflectConv(f, f, 3)
        self.BatchStatsNorm_1 = BatchStatsNorm(f)

    def forward(self, x, per_sample):
        y = F.relu(self.BatchStatsNorm_0(self.ReflectConv_0(x), per_sample))
        return x + self.BatchStatsNorm_1(self.ReflectConv_1(y), per_sample)


class CompositeWeightUnet(nn.Module):
    def __init__(self, cin, ngf=32, n_down=2, n_blocks=3):
        super().__init__()
        self.n_down, self.n_blocks = n_down, n_blocks
        self.ReflectConv_0 = ReflectConv(cin, ngf, 7)
        self.BatchStatsNorm_0 = BatchStatsNorm(ngf)
        conv, norm, c = 0, 1, ngf
        for i in range(n_down):
            f = ngf * 2 ** i * 2
            self.add_module(f"Conv_{conv}", Conv2d(c, f, 3, 2, 1))
            self.add_module(f"BatchStatsNorm_{norm}", BatchStatsNorm(f))
            conv, norm, c = conv + 1, norm + 1, f
        for i in range(n_blocks):
            self.add_module(f"_ResnetBlock_{i}", _ResnetBlock(c))
        for i in range(n_down):
            f = ngf * 2 ** (n_down - i) // 2
            self.add_module(f"Conv_{conv}", Conv2d(c, f, 3, 1, 1))
            self.add_module(f"BatchStatsNorm_{norm}", BatchStatsNorm(f))
            conv, norm, c = conv + 1, norm + 1, f
        self.ReflectConv_1 = ReflectConv(c, 1, 7)

    def forward(self, x, per_sample):
        x = F.relu(self.BatchStatsNorm_0(self.ReflectConv_0(x), per_sample))
        conv, norm = 0, 1
        for _ in range(self.n_down):
            x = getattr(self, f"Conv_{conv}")(x)
            x = F.relu(getattr(self, f"BatchStatsNorm_{norm}")(x, per_sample))
            conv, norm = conv + 1, norm + 1
        for i in range(self.n_blocks):
            x = getattr(self, f"_ResnetBlock_{i}")(x, per_sample)
        for _ in range(self.n_down):
            H, W = x.shape[-2:]
            x = resize_bilinear(x, (2 * H, 2 * W), False)
            x = getattr(self, f"Conv_{conv}")(x)
            x = F.relu(getattr(self, f"BatchStatsNorm_{norm}")(x, per_sample))
            conv, norm = conv + 1, norm + 1
        return torch.sigmoid(self.ReflectConv_1(x))


class Propagation3DFlowNet(nn.Module):
    """Blend the flow-warped reference frame (masked by the SMPL mask) with
    the generated frame by a predicted per-pixel weight."""

    def __init__(self):
        super().__init__()
        self.CompositeWeightUnet_0 = CompositeWeightUnet(9)

    def forward(self, fake, tsf, iuv, smpl_mask,
                per_sample_norm) -> Dict[str, torch.Tensor]:
        tsf = tsf * smpl_mask
        w = self.CompositeWeightUnet_0(torch.cat([tsf, fake, iuv], 1),
                                       per_sample_norm)
        return {"pred_target": fake * w + tsf * (1.0 - w), "weight": w}


class _ConvBNLReLU(nn.Module):
    def __init__(self, cin, f, norm):
        super().__init__()
        self.norm = norm
        self.Conv_0 = Conv2d(cin, f, 3, 2, 1, bias=False)
        if norm:
            self.BatchStatsNorm_0 = BatchStatsNorm(f)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.norm:
            x = self.BatchStatsNorm_0(x, per_sample=False)
        return F.leaky_relu(x, 0.2)


class _MLPHead(nn.Module):
    """Flatten in (H, W, C) order, Dense(100), LeakyReLU(0.2), Dense(1),
    sigmoid."""

    def __init__(self, cin):
        super().__init__()
        self.Dense_0 = Linear(cin, 100)
        self.Dense_1 = Linear(100, 1)

    def forward(self, x):
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.sigmoid(self.Dense_1(F.leaky_relu(self.Dense_0(x), 0.2)))


class Discriminator(nn.Module):
    def __init__(self, image_size, n_layers, ndf=32, cin=6):
        super().__init__()
        widths = [(ndf, False), (2 * ndf, True), (2 * ndf, True),
                  (4 * ndf, True), (4 * ndf, True), (8 * ndf, True)]
        c, side = cin, image_size
        for i, (f, norm) in enumerate(widths[:n_layers]):
            self.add_module(f"_ConvBNLReLU_{i}", _ConvBNLReLU(c, f, norm))
            c, side = f, (side + 1) // 2
        self.n_layers = n_layers
        self._MLPHead_0 = _MLPHead(c * side * side)

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"_ConvBNLReLU_{i}")(x)
        return self._MLPHead_0(x)


class VGG19Features(nn.Module):
    """VGG19's convs with 2x2 average pools; the pre-ReLU outputs of
    conv1_2 .. conv5_2."""

    BLOCKS = ((64, 64), (128, 128), (256,) * 4, (512,) * 4, (512,) * 4)

    def __init__(self):
        super().__init__()
        cin = 3
        for b, widths in enumerate(self.BLOCKS):
            for i, w in enumerate(widths):
                self.add_module(f"conv{b + 1}_{i + 1}",
                                Conv2d(cin, w, 3, padding=1))
                cin = w

    def forward(self, x):
        feats = []
        for b, widths in enumerate(self.BLOCKS):
            for i in range(len(widths)):
                x = getattr(self, f"conv{b + 1}_{i + 1}")(x)
                if i == 1:
                    feats.append(x)
                x = F.relu(x)
            x = F.avg_pool2d(x, 2, 2)
        return feats


class JAFPro(nn.Module):
    """The module bundle under the port's names."""

    def __init__(self, image_size=256, face_crop_size=64, parts=24):
        super().__init__()
        self.accu = AccumulateLSTM(parts)
        self.inpaint = UNetInpainter(parts)
        self.bg = CRNSmaller(fg=False)
        self.refine = CRNSmaller(fg=True)
        self.pro = Propagation3DFlowNet()
        self.D = Discriminator(image_size, 6)
        self.FD = Discriminator(face_crop_size, 4)
        self.vgg = VGG19Features()
        self.vgg.requires_grad_(False)


GENERATOR = ("accu", "inpaint", "bg", "refine", "pro")


def build(image_size=256, face_crop_size=64, parts=24,
          modules: Optional[Sequence[str]] = None, device="cpu") -> JAFPro:
    """The bundle on ``device``, parameters uninitialised (``weights.fill``
    fills them); with ``modules`` only those are kept."""
    with torch.device(device):
        net = JAFPro(image_size, face_crop_size, parts)
    if modules is not None:
        for name in list(net._modules):
            if name not in modules:
                delattr(net, name)
    return net
