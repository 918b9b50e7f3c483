"""The ablation zoo (port of ``jafpro_tpu/models/ablations.py``), NCHW.

The reference's unused networks, as the JAX package rebuilt them:
alternative texture fusions, the texture U-Nets, the latent-code max
fusion, vid2vid's predictive and blending modules, EdgeConnect's
generators and discriminator, pix2pix's discriminators, ESRGAN's blocks
and the CRN variants. No production path reaches them; they run on cuDNN
and torch ops, tuned for correctness, not speed.

Children carry flax's names, so ``bridge.py`` carries a JAX tree across.
Part stacks are (B, N, P, h, w, 3) as in the JAX package; a per-part
network runs as one grouped network over part-major packed channels
(``models/parts.py``), also where flax vmaps one-part networks
(``MaxFusionModule``'s ``encoders``/``decoders``), whose stacked leaves
the bridge concatenates (``models.common.mark_vmapped``). Every network
class is built on ``device`` (the card unless the caller asks for the
CPU) with flax's initialisers drawn from ``generator``; ``device=None``
builds a child, which its parent initialises and places.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jafpro_tpu_torch.models.common import (
    Conv2d, ConvBlock, ConvLReLU, ConvTranspose2d, Linear, SpectralNorm,
    UpsampleConvLReLU, mark_vmapped, place, reflect_pad)
from jafpro_tpu_torch.models.parts import (
    ENC_NC, PartConv, PartDecoder, PartEncoder, pack_parts, unpack_parts)
from jafpro_tpu_torch.ops.image import avg_pool_3x3s2
from jafpro_tpu_torch.ops.sampling import (
    grid_sample, resize_bilinear, resize_nearest)

Generator = Optional[torch.Generator]

# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class TorchConvTranspose(nn.Module):
    """torch ``ConvTranspose2d(k, s, p)``: flax's VALID transpose cropped by
    ``pad`` on every side. ``groups`` P: P independent layers over
    part-major packed channels (``cin`` and ``features`` per part)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int,
                 pad: int, compute_dtype=None, groups: int = 1):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2d(
            groups * cin, groups * features, kernel, stride, pad,
            groups=groups, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.ConvTranspose_0(x)


class InstanceNorm(nn.Module):
    """torch ``InstanceNorm2d(affine=False)``: per (sample, channel) over
    space, biased variance, in float32."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return _instance_norm(x, self.eps)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.instance_norm(x.float(), eps=eps).to(x.dtype)


class InstanceNorm1d(nn.Module):
    """torch-1.2 ``InstanceNorm1d`` as the reference calls it on a
    (B, 1, 256) code: each sample normalised over its last axis (the 256
    features), biased variance, no affine."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return _instance_norm_1d(x, self.eps)


def _instance_norm_1d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _conv(cin, cout, k, stride=1, pad=None, cd=None):
    """flax ``nn.Conv`` with a symmetric padding (default ``k // 2``)."""
    return Conv2d(cin, cout, k, stride, k // 2 if pad is None else pad,
                  compute_dtype=cd)


def _in_relu(x):
    return F.relu(_instance_norm(x))


# ---------------------------------------------------------------------------
# the texture U-Nets
# ---------------------------------------------------------------------------


class UNetSE(nn.Module):
    """The single-part texture U-Net: ``PartEncoder``/``PartDecoder`` with
    one part. x (B, cin, h, w) -> (B, 3, h, w)."""

    def __init__(self, cin: int = 3, enc_nc: Sequence[int] = ENC_NC,
                 dec_nc: Sequence[int] = (48, 24, 12, 6), compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        self.PartEncoder_0 = PartEncoder(1, cin, enc_nc,
                                         compute_dtype=compute_dtype)
        self.PartDecoder_0 = PartDecoder(1, dec_nc, enc_nc,
                                         compute_dtype=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        return self.PartDecoder_0(self.PartEncoder_0(x))


class UNetGenerator(nn.Module):
    """The full-image U-Net: an 11-conv encoder (7x7 stem, five stride-2
    stages), a decoder that resizes to each skip's size and concats it,
    a 3-channel head. x (B, cin, H, W) -> (B, 3, H, W)."""

    def __init__(self, cin: int = 3,
                 enc_nc: Sequence[int] = (64, 64, 128, 128, 128, 128, 128,
                                          128, 128, 128, 128),
                 dec_nc: Sequence[int] = (128, 128, 128, 128, 64),
                 compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        nc = enc_nc
        c = cin
        for i, f in enumerate(nc):
            self.add_module(f"ConvLReLU_{i}", ConvLReLU(
                c, f, kernel=7 if i == 0 else 3,
                stride=2 if i % 2 else 1, compute_dtype=compute_dtype))
            c = f
        for i, (f, cs) in enumerate(zip(dec_nc, (nc[8], nc[6], nc[4], nc[2],
                                                  nc[0]))):
            self.add_module(f"UpsampleConvLReLU_{i}", UpsampleConvLReLU(
                c, cs, f, None, compute_dtype=compute_dtype))
            c = f
        self.Conv_0 = _conv(c, 3, 3, cd=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        outs = []
        for i in range(11):
            x = getattr(self, f"ConvLReLU_{i}")(x)
            outs.append(x)
        h = x
        for i, skip in enumerate((outs[8], outs[6], outs[4], outs[2],
                                  outs[0])):
            h = getattr(self, f"UpsampleConvLReLU_{i}")(h, skip)
        return self.Conv_0(h)


class UNetTA(nn.Module):
    """The whole-atlas texture U-Net: a 9-conv encoder over the atlas and a
    4-level decoder (resize to the skip, concat, conv) back to its size.
    x (B, cin, H, W) -> (B, 3, H, W)."""

    def __init__(self, cin: int = 3, enc_nc: Sequence[int] = ENC_NC,
                 dec_nc: Sequence[int] = (48, 24, 12, 6), compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        nc = enc_nc
        c = cin
        for i, f in enumerate(nc[:9]):
            self.add_module(f"ConvLReLU_{i}", ConvLReLU(
                c, f, kernel=7 if i == 0 else 3,
                stride=2 if i % 2 else 1, compute_dtype=compute_dtype))
            c = f
        for i, (f, cs) in enumerate(zip(dec_nc, (nc[6], nc[4], nc[2],
                                                  nc[0]))):
            self.add_module(f"ConvLReLU_{9 + i}", ConvLReLU(
                c + cs, f, compute_dtype=compute_dtype))
            c = f
        self.Conv_0 = _conv(c, 3, 3, cd=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        outs = []
        for i in range(9):
            x = getattr(self, f"ConvLReLU_{i}")(x)
            outs.append(x)
        h = x
        for i, skip in enumerate((outs[6], outs[4], outs[2], outs[0])):
            h = _resize_cat_conv(h, skip, getattr(self, f"ConvLReLU_{9 + i}"))
        return self.Conv_0(h)


def _resize_cat_conv(x, skip, conv):
    x = resize_bilinear(x, tuple(skip.shape[-2:]), align_corners=True)
    return conv(torch.cat([x, skip], dim=1))


# ---------------------------------------------------------------------------
# fusion ablations over the 24-part atlas: (B, N, P, h, w, 3) -> (B, P, h, w, 3)
# ---------------------------------------------------------------------------


def _encode_refs(encoder, parts):
    """Each reference through the shared per-part encoder: the skips,
    (B*N, P*c, hs, ws) each."""
    B, N, P, h, w, C = parts.shape
    return encoder(pack_parts(parts.reshape(B * N, P, h, w, C)))


class AccumulatePlain(nn.Module):
    """``Accumulate``: the N references of a part concatenated on its
    channels into the part's U-Net, no recurrence."""

    def __init__(self, parts: int = 24, refs: int = 4, compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        self.parts = parts
        self.PartEncoder_0 = PartEncoder(parts, refs * 3,
                                         compute_dtype=compute_dtype)
        self.PartDecoder_0 = PartDecoder(parts, compute_dtype=compute_dtype)
        place(self, device, generator)

    def forward(self, parts: torch.Tensor) -> torch.Tensor:
        B, N, P, h, w, C = parts.shape
        x = parts.permute(0, 2, 3, 4, 1, 5).reshape(B, P, h, w, N * C)
        out = self.PartDecoder_0(self.PartEncoder_0(pack_parts(x)))
        return unpack_parts(out, P)


class _ReduceFusion(nn.Module):
    """``Accumulate_{max,avg}_fusion``: each reference through the shared
    per-part encoder, each skip level reduced over the references
    channel by channel, one decode."""

    REDUCE = "max"

    def __init__(self, parts: int = 24, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.PartEncoder_0 = PartEncoder(parts, compute_dtype=compute_dtype)
        self.PartDecoder_0 = PartDecoder(parts, compute_dtype=compute_dtype)
        place(self, device, generator)

    def forward(self, parts: torch.Tensor) -> torch.Tensor:
        B, N, P = parts.shape[:3]
        fused = []
        for s in _encode_refs(self.PartEncoder_0, parts):
            s = s.reshape(B, N, *s.shape[1:])
            fused.append(s.amax(1) if self.REDUCE == "max" else s.mean(1))
        return unpack_parts(self.PartDecoder_0(tuple(fused)), P)


class AccumulateMaxFusion(_ReduceFusion):
    REDUCE = "max"


class AccumulateAvgFusion(_ReduceFusion):
    REDUCE = "mean"


class AccumulateMask(nn.Module):
    """``Accumulate_mask``: each reference through the shared per-part
    encoder; per skip level a per-part conv (``mask{level}``) over the
    references' concatenated features predicts an N-way softmax mask, and
    the level is the mask-weighted sum of the references."""

    def __init__(self, parts: int = 24, refs: int = 4, compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        self.PartEncoder_0 = PartEncoder(parts, compute_dtype=compute_dtype)
        for level in range(5):
            self.add_module(f"mask{level}", PartConv(
                parts, refs * ENC_NC[2 * level], refs,
                kernel=5 if level == 0 else 3, compute_dtype=compute_dtype))
        self.PartDecoder_0 = PartDecoder(parts, compute_dtype=compute_dtype)
        place(self, device, generator)

    def forward(self, parts: torch.Tensor) -> torch.Tensor:
        B, N, P = parts.shape[:3]
        fused = []
        for level, s in enumerate(_encode_refs(self.PartEncoder_0, parts)):
            hs, ws = s.shape[-2:]
            f = s.reshape(B, N, P, -1, hs, ws)
            f_cat = f.permute(0, 2, 1, 3, 4, 5).reshape(B, -1, hs, ws)
            logits = getattr(self, f"mask{level}")(f_cat)
            m = torch.softmax(logits.reshape(B, P, N, hs, ws), dim=2)
            blend = (f * m.permute(0, 2, 1, 3, 4)[:, :, :, None]).sum(1)
            fused.append(blend.reshape(B, -1, hs, ws))
        return unpack_parts(self.PartDecoder_0(tuple(fused)), P)


# ---------------------------------------------------------------------------
# latent-code fusion
# ---------------------------------------------------------------------------


def _maxpool(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Max pool k3 s2 over a -inf padding of ``pad``."""
    return F.max_pool2d(x, 3, 2, padding=pad)


class CodeEncoder(nn.Module):
    """``encoder``: 7x [ConvBlock, maxpool] from one 200x200 part
    (B, 3, 200, 200) to a 256-d code (B, 256). ``parts`` P > 1: P
    independent encoders over packed (B, P*3, 200, 200) -> (B, P*256),
    each layer norm with statistics per sample and per part."""

    CHANS = (16, 32, 32, 64, 64, 128, 256)
    PADS = (1, 1, 1, 0, 1, 1, 0)

    def __init__(self, parts: int = 1, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        c = 3
        for i, f in enumerate(self.CHANS):
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                1, c, f, compute_dtype=compute_dtype, groups=parts))
            c = f
        place(self, device, generator)

    def forward(self, x):
        for i, p in enumerate(self.PADS):
            x = _maxpool(getattr(self, f"ConvBlock_{i}")(x), p)
        return x.reshape(x.shape[0], -1)


class CodeDecoder(nn.Module):
    """``decoder``: 7 transposed convs from a 512-d code (B, 512) back to a
    200x200 part (B, 3, 200, 200), tanh head. ``parts`` P > 1: P
    independent decoders, (B, P*512) -> (B, P*3, 200, 200)."""

    SPEC = ((256, 3, 2, 0), (128, 4, 2, 1), (64, 4, 2, 1), (32, 3, 2, 0),
            (16, 4, 2, 1), (16, 4, 2, 1), (16, 4, 2, 1))

    def __init__(self, parts: int = 1, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        c = 512
        for i, (f, k, s, p) in enumerate(self.SPEC):
            self.add_module(f"TorchConvTranspose_{i}", TorchConvTranspose(
                c, f, k, s, p, compute_dtype=compute_dtype, groups=parts))
            c = f
        self.Conv_0 = Conv2d(parts * c, parts * 3, 1, groups=parts,
                             compute_dtype=compute_dtype)
        place(self, device, generator)

    def forward(self, code):
        x = code.reshape(code.shape[0], -1, 1, 1)
        for i in range(len(self.SPEC)):
            x = F.leaky_relu(getattr(self, f"TorchConvTranspose_{i}")(x),
                             0.01)
        return torch.tanh(self.Conv_0(x))


class MaxFusionModule(nn.Module):
    """``max_fusion_module``: every part of every reference to a 256-d
    code; the P part codes concatenated (P*256) through a 5-layer
    InstanceNorm1d MLP; both codes max-fused over the references; each
    part decoded from [projected global (256) | its fused code (256)].
    flax vmaps ``encoders``/``decoders`` over the parts with stacked
    parameters; here each is one grouped network."""

    def __init__(self, parts: int = 24, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.parts = parts
        self.encoders = mark_vmapped(CodeEncoder(
            parts, compute_dtype=compute_dtype, device=None), parts)
        for i in range(5):
            self.add_module(f"Dense_{i}", Linear(
                parts * 256 if i == 0 else 256, 256,
                compute_dtype=compute_dtype))
        self.decoders = mark_vmapped(CodeDecoder(
            parts, compute_dtype=compute_dtype, device=None), parts)
        place(self, device, generator)

    def forward(self, parts: torch.Tensor) -> torch.Tensor:
        B, N, P, h, w, C = parts.shape
        codes = self.encoders(pack_parts(parts.reshape(B * N, P, h, w, C)))
        proj = codes.reshape(B * N, 1, P * 256)
        for i in range(5):
            proj = F.relu(_instance_norm_1d(getattr(self, f"Dense_{i}")(proj)))
        fus_part = codes.reshape(B, N, P, 256).amax(1)
        fus_proj = proj.reshape(B, N, 256).amax(1)
        dec_in = torch.cat([fus_proj[:, None].expand(B, P, 256), fus_part],
                           dim=-1)
        return unpack_parts(self.decoders(dec_in.reshape(B, P * 512)), P)


# ---------------------------------------------------------------------------
# vid2vid modules
# ---------------------------------------------------------------------------


class Vid2VidResnetBlock(nn.Module):
    """vid2vid ``ResnetBlock``: 3x3 conv, InstanceNorm, ReLU, 3x3 conv,
    InstanceNorm, residual add."""

    def __init__(self, features: int, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.Conv_0 = _conv(features, features, 3, cd=compute_dtype)
        self.Conv_1 = _conv(features, features, 3, cd=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        h = self.Conv_1(_in_relu(self.Conv_0(x)))
        return x + _instance_norm(h)


class PredictiveModule(nn.Module):
    """vid2vid ``PredictiveModule``: a 3-conv encoder (64, 128, 256; two
    stride-2), ``n_blocks`` resblocks at 256, two stride-2 3x3 transposed
    convs back, tanh head. flax's SAME transposed conv pads the dilated
    input (2, 1); torch's ``padding=1, output_padding=1`` pads it (1, 2)
    and gives another result, so each runs unpadded and drops its last row
    and column. x (B, cin, H, W) -> (B, 3, H, W)."""

    def __init__(self, cin: int = 9, n_blocks: int = 6, compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        self.n_blocks = n_blocks
        c = cin
        for i, (f, s) in enumerate(((64, 1), (128, 2), (256, 2))):
            self.add_module(f"Conv_{i}", _conv(c, f, 3, s, cd=compute_dtype))
            c = f
        for i in range(n_blocks):
            self.add_module(f"Vid2VidResnetBlock_{i}", Vid2VidResnetBlock(
                256, compute_dtype=compute_dtype, device=None))
        for i, f in enumerate((128, 64)):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose2d(
                c, f, 3, 2, crop_end=1, compute_dtype=compute_dtype))
            c = f
        self.Conv_3 = _conv(c, 3, 3, cd=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        for i in range(3):
            x = _in_relu(getattr(self, f"Conv_{i}")(x))
        for i in range(self.n_blocks):
            x = getattr(self, f"Vid2VidResnetBlock_{i}")(x)
        for i in range(2):
            x = _in_relu(getattr(self, f"ConvTranspose_{i}")(x))
        return torch.tanh(self.Conv_3(x))


class BlendingModule(nn.Module):
    """vid2vid ``BlendingModule``: a residual corrector of the predictive
    output from [predictive, warped, target IUV] (3 + 3 + 3 channels)."""

    def __init__(self, cin: int = 9, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.Conv_0 = _conv(cin, 64, 3, cd=compute_dtype)
        for i in range(3):
            self.add_module(f"Vid2VidResnetBlock_{i}", Vid2VidResnetBlock(
                64, compute_dtype=compute_dtype, device=None))
        self.Conv_1 = _conv(64, 3, 3, cd=compute_dtype)
        place(self, device, generator)

    def forward(self, predictive, warped, tgt_iuv):
        x = _in_relu(self.Conv_0(torch.cat([predictive, warped, tgt_iuv], 1)))
        for i in range(3):
            x = getattr(self, f"Vid2VidResnetBlock_{i}")(x)
        return torch.tanh(self.Conv_1(x)) + predictive


# ---------------------------------------------------------------------------
# EdgeConnect
# ---------------------------------------------------------------------------


class _SNConv(nn.Module):
    """A conv, spectrally normalised as flax's ``nn.SpectralNorm`` does
    when ``spectral`` (``SpectralNorm_0`` holds ``u`` and ``sigma``).
    ``forward(x, update_sn)``: ``update_sn`` stores the new state."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 pad: int = 0, dilation: int = 1, use_bias: bool = True,
                 spectral: bool = False, compute_dtype=None):
        super().__init__()
        self.spectral = spectral
        self.Conv_0 = Conv2d(cin, features, kernel, stride, pad,
                             bias=use_bias, dilation=dilation,
                             compute_dtype=compute_dtype)
        if spectral:
            self.SpectralNorm_0 = SpectralNorm(features)

    def forward(self, x, update_sn: bool = False):
        if not self.spectral:
            return self.Conv_0(x)
        return self.Conv_0(x, self.SpectralNorm_0(self.Conv_0.weight,
                                                  update_sn))


class EdgeConnectResnetBlock(nn.Module):
    """EdgeConnect ``ResnetBlock``: reflect-padded dilated 3x3 conv,
    InstanceNorm, ReLU, reflect-padded 3x3 conv, InstanceNorm, residual."""

    def __init__(self, features: int, dilation: int = 2,
                 spectral: bool = False, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.dilation = dilation
        self._SNConv_0 = _SNConv(features, features, 3, dilation=dilation,
                                 use_bias=not spectral, spectral=spectral,
                                 compute_dtype=compute_dtype)
        self._SNConv_1 = _SNConv(features, features, 3,
                                 use_bias=not spectral, spectral=spectral,
                                 compute_dtype=compute_dtype)
        place(self, device, generator)

    def forward(self, x, update_sn: bool = False):
        h = self._SNConv_0(reflect_pad(x, self.dilation), update_sn)
        h = self._SNConv_1(reflect_pad(_in_relu(h), 1), update_sn)
        return x + _instance_norm(h)


class _EdgeConnectGenerator(nn.Module):
    """The shape both EdgeConnect generators share: reflect-padded 7x7
    stem, two stride-2 4x4 convs, dilated resblocks at 256, two 4x4
    transposed convs, reflect-padded 7x7 head."""

    def _build(self, cin, cout, residual_blocks, spectral, cd):
        self.residual_blocks = residual_blocks
        self.spectral = spectral
        for i, (c, f, k, s, p) in enumerate(((cin, 64, 7, 1, 0),
                                             (64, 128, 4, 2, 1),
                                             (128, 256, 4, 2, 1))):
            if spectral:
                self.add_module(f"_SNConv_{i}", _SNConv(
                    c, f, k, s, p, spectral=True, compute_dtype=cd))
            else:
                self.add_module(f"Conv_{i}", _conv(c, f, k, s, p, cd=cd))
        for i in range(residual_blocks):
            self.add_module(f"EdgeConnectResnetBlock_{i}",
                            EdgeConnectResnetBlock(256, spectral=spectral,
                                                   compute_dtype=cd,
                                                   device=None))
        for i, (c, f) in enumerate(((256, 128), (128, 64))):
            self.add_module(f"TorchConvTranspose_{i}", TorchConvTranspose(
                c, f, 4, 2, 1, compute_dtype=cd))
        self.add_module("Conv_0" if spectral else "Conv_3",
                        _conv(64, cout, 7, pad=0, cd=cd))

    def _run(self, x, update_sn):
        for i in range(3):
            if i == 0:
                x = reflect_pad(x, 3)
            if self.spectral:
                x = getattr(self, f"_SNConv_{i}")(x, update_sn)
            else:
                x = getattr(self, f"Conv_{i}")(x)
            x = _in_relu(x)
        for i in range(self.residual_blocks):
            x = getattr(self, f"EdgeConnectResnetBlock_{i}")(x, update_sn)
        for i in range(2):
            x = _in_relu(getattr(self, f"TorchConvTranspose_{i}")(x))
        head = self.Conv_0 if self.spectral else self.Conv_3
        return head(reflect_pad(x, 3))


class InpaintGenerator(_EdgeConnectGenerator):
    """EdgeConnect ``InpaintGenerator``: (B, in_features, H, W) ->
    (B, 3, H, W) in [0, 1] as (tanh + 1) / 2."""

    def __init__(self, residual_blocks: int = 8, in_features: int = 6,
                 compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self._build(in_features, 3, residual_blocks, False, compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        return (torch.tanh(self._run(x, False)) + 1.0) / 2.0


class EdgeGenerator(_EdgeConnectGenerator):
    """EdgeConnect ``EdgeGenerator``: spectrally normalised convs (not the
    transposed ones), a sigmoid 1-channel edge head. ``forward(x,
    update_sn)``."""

    def __init__(self, residual_blocks: int = 8, in_features: int = 3,
                 compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self._build(in_features, 1, residual_blocks, True, compute_dtype)
        place(self, device, generator)

    def forward(self, x, update_sn: bool = False):
        return torch.sigmoid(self._run(x, update_sn))


class PatchDiscriminator70(nn.Module):
    """EdgeConnect ``Discriminator``: 5 spectrally normalised 4x4 convs;
    returns (patch probabilities, or logits without ``use_sigmoid``, and
    the list of the five layers' outputs)."""

    SPEC = ((64, 2), (128, 2), (256, 2), (512, 1), (1, 1))

    def __init__(self, in_features: int = 3, use_sigmoid: bool = True,
                 compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        c = in_features
        for i, (f, s) in enumerate(self.SPEC):
            self.add_module(f"_SNConv_{i}", _SNConv(
                c, f, 4, s, 1, use_bias=False, spectral=True,
                compute_dtype=compute_dtype))
            c = f
        place(self, device, generator)

    def forward(self, x, update_sn: bool = False):
        feats = []
        for i in range(len(self.SPEC)):
            x = getattr(self, f"_SNConv_{i}")(x, update_sn)
            if i < 4:
                x = F.leaky_relu(x, 0.2)
            feats.append(x)
        return (torch.sigmoid(x) if self.use_sigmoid else x), feats


# ---------------------------------------------------------------------------
# pix2pix
# ---------------------------------------------------------------------------


class NLayerDiscriminator(nn.Module):
    """pix2pix PatchGAN, InstanceNorm variant."""

    def __init__(self, in_features: int = 3, ndf: int = 64,
                 n_layers: int = 3, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.n_layers = n_layers
        cd = compute_dtype
        self.Conv_0 = _conv(in_features, ndf, 4, 2, 1, cd=cd)
        c = ndf
        for n in range(1, n_layers):
            f = ndf * min(2 ** n, 8)
            self.add_module(f"Conv_{n}", _conv(c, f, 4, 2, 1, cd=cd))
            c = f
        f = ndf * min(2 ** n_layers, 8)
        self.add_module(f"Conv_{n_layers}", _conv(c, f, 4, 1, 1, cd=cd))
        self.add_module(f"Conv_{n_layers + 1}", _conv(f, 1, 4, 1, 1, cd=cd))
        place(self, device, generator)

    def forward(self, x):
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            x = F.leaky_relu(_instance_norm(getattr(self, f"Conv_{n}")(x)),
                             0.2)
        return getattr(self, f"Conv_{self.n_layers + 1}")(x)


class PixelDiscriminator(nn.Module):
    """pix2pix 1x1 PixelGAN."""

    def __init__(self, in_features: int = 3, ndf: int = 64,
                 compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.Conv_0 = _conv(in_features, ndf, 1, cd=compute_dtype)
        self.Conv_1 = _conv(ndf, 2 * ndf, 1, cd=compute_dtype)
        self.Conv_2 = _conv(2 * ndf, 1, 1, cd=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        x = F.leaky_relu(_instance_norm(self.Conv_1(x)), 0.2)
        return self.Conv_2(x)


def lsgan_loss(pred: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """``GANLoss(use_lsgan=True)``: the mean squared distance to a constant
    1 (real) or 0 target, in float32."""
    target = 1.0 if target_is_real else 0.0
    sq = torch.square(pred.float() - target)
    return torch.sum(sq) / sq.numel()   # a division, as jnp.mean divides


# ---------------------------------------------------------------------------
# ESRGAN / EDSR blocks
# ---------------------------------------------------------------------------


class EDSRResBlock(nn.Module):
    """3x3 conv, ReLU, 3x3 conv, residual scaled by ``res_scale``."""

    def __init__(self, features: int, res_scale: float = 1.0,
                 compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        self.res_scale = res_scale
        self.Conv_0 = _conv(features, features, 3, cd=compute_dtype)
        self.Conv_1 = _conv(features, features, 3, cd=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        return x + self.Conv_1(F.relu(self.Conv_0(x))) * self.res_scale


class ResidualDenseBlock5C(nn.Module):
    """``ResidualDenseBlock_5C``: 5 densely connected 3x3 convs with
    LeakyReLU(0.2), residual scaled by 0.2."""

    def __init__(self, features: int, growth: int = 32, compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv(features + i * growth, growth,
                                               3, cd=compute_dtype))
        self.Conv_4 = _conv(features + 4 * growth, features, 3,
                            cd=compute_dtype)
        place(self, device, generator)

    def forward(self, x):
        inputs = x
        for i in range(4):
            h = F.leaky_relu(getattr(self, f"Conv_{i}")(inputs), 0.2)
            inputs = torch.cat([inputs, h], dim=1)
        return x + 0.2 * self.Conv_4(inputs)


class RRDB(nn.Module):
    """``RRDB``: 3 chained dense blocks, residual scaled by 0.2."""

    def __init__(self, features: int, growth: int = 32, compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        for i in range(3):
            self.add_module(f"ResidualDenseBlock5C_{i}", ResidualDenseBlock5C(
                features, growth, compute_dtype=compute_dtype, device=None))
        place(self, device, generator)

    def forward(self, x):
        h = x
        for i in range(3):
            h = getattr(self, f"ResidualDenseBlock5C_{i}")(h)
        return x + 0.2 * h


# ---------------------------------------------------------------------------
# CRN extras
# ---------------------------------------------------------------------------


class AutoEncoder(nn.Module):
    """``AutoEncoder``: 6x [ConvBlock, maxpool/2], an image embedder
    (B, cin, H, W) -> (B, 128, H/64, W/64)."""

    SPEC = ((2, 16), (2, 32), (3, 64), (3, 64), (3, 128), (3, 128))

    def __init__(self, cin: int = 3, compute_dtype=None, device="cuda",
                 generator: Generator = None):
        super().__init__()
        c = cin
        for i, (r, f) in enumerate(self.SPEC):
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                r, c, f, compute_dtype=compute_dtype))
            c = f
        place(self, device, generator)

    def forward(self, x):
        for i in range(len(self.SPEC)):
            x = _maxpool(getattr(self, f"ConvBlock_{i}")(x), 1)
        return x


class CRNAuto(nn.Module):
    """``CRN_Auto``: a CRN whose deepest decoder level also sees an
    ``AutoEncoder`` embedding of the source image. ``forward(label, sp,
    src_img)``: label (B, cin, sp, sp), sp >= 64 -> (B, 3, sp, sp)."""

    ENC = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512), (3, 512))

    def __init__(self, cin: int = 6, src_cin: int = 3, compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        cd = compute_dtype
        self.AutoEncoder_0 = AutoEncoder(src_cin, compute_dtype=cd,
                                         device=None)
        c = cin
        for i, (r, f) in enumerate(self.ENC):
            self.add_module(f"ConvBlock_{i}", ConvBlock(r, c, f,
                                                        compute_dtype=cd))
            c = f
        prev = 0
        for i, lvl in enumerate(range(6, 0, -1)):   # decoder levels 6..1
            extra = AutoEncoder.SPEC[-1][1] if lvl == 6 else 0
            f = 512 if lvl > 1 else 256
            self.add_module(f"ConvBlock_{6 + i}", ConvBlock(
                2, cin + self.ENC[lvl - 1][1] + extra + prev, f,
                compute_dtype=cd))
            prev = f
        self.ConvBlock_12 = ConvBlock(2, cin + prev, 256, compute_dtype=cd)
        self.Conv_0 = Conv2d(256, 3, 1, compute_dtype=cd)
        place(self, device, generator)

    def forward(self, label: torch.Tensor, sp: int, src_img: torch.Tensor):
        embed = self.AutoEncoder_0(src_img)
        pools, x = [], label
        for i in range(6):
            x = avg_pool_3x3s2(getattr(self, f"ConvBlock_{i}")(x))
            pools.append(x)
        net = None
        for i, lvl in enumerate(range(6, 0, -1)):
            size = sp // (2 ** lvl)
            feats = [resize_bilinear(label, (size, size), True),
                     pools[lvl - 1]]
            if lvl == 6:
                feats.append(resize_bilinear(embed, (size, size), True))
            if net is not None:
                feats.append(net)
            x = getattr(self, f"ConvBlock_{6 + i}")(torch.cat(feats, 1))
            up = sp // (2 ** (lvl - 1))
            net = resize_bilinear(x, (up, up), True)
        return self.Conv_0(self.ConvBlock_12(torch.cat([label, net], 1)))


class SpatioTempoCRN(nn.Module):
    """``SpatioTempoCRN``: a twin-stream CRN over (current, previous)
    labels with shared weights, whose every decoder level also sees the
    other stream's encoder features warped by the inter-frame flow
    (``grid_sample``, border padding). ``forward(label, prev_label, sp,
    flow)``: labels (B, cin, sp, sp), sp >= 64; flow (B, 2, sp, sp), a
    backward flow in [-1, 1] grid units, channel 0 x (the reference
    computes it with a frozen FlowNetSD; zeros at test time) -> (current,
    previous) syntheses, (B, 3, sp, sp) each."""

    def __init__(self, cin: int = 6, ngf: int = 512, compute_dtype=None,
                 device="cuda", generator: Generator = None):
        super().__init__()
        cd = compute_dtype
        self.enc = ((2, 64), (2, 128), (3, 256), (3, ngf), (3, ngf),
                    (3, ngf))
        c = cin
        for i, (r, f) in enumerate(self.enc):
            self.add_module(f"ConvBlock_{i}", ConvBlock(r, c, f,
                                                        compute_dtype=cd))
            c = f
        prev = 0
        for i, lvl in enumerate(range(6, 0, -1)):
            f = ngf if lvl > 1 else 256
            self.add_module(f"ConvBlock_{6 + i}", ConvBlock(
                2, cin + 2 * self.enc[lvl - 1][1] + prev, f,
                compute_dtype=cd))
            prev = f
        self.ConvBlock_12 = ConvBlock(2, cin + prev, 256, compute_dtype=cd)
        self.Conv_0 = Conv2d(256, 3, 1, compute_dtype=cd)
        place(self, device, generator)

    def _encode(self, x):
        pools = []
        for i in range(6):
            x = avg_pool_3x3s2(getattr(self, f"ConvBlock_{i}")(x))
            pools.append(x)
        return pools

    def forward(self, label, prev_label, sp: int, flow):
        pools, prev_pools = self._encode(label), self._encode(prev_label)
        B = label.shape[0]
        net = prev_net = None
        for i, lvl in enumerate(range(6, 0, -1)):
            size = sp // (2 ** lvl)
            lin = torch.linspace(-1.0, 1.0, size, device=label.device)
            ys, xs = torch.meshgrid(lin, lin, indexing="ij")
            grid = torch.stack([xs, ys], -1).expand(B, size, size, 2)
            fl = resize_nearest(flow, (size, size)).permute(0, 2, 3, 1)
            warped_prev = grid_sample(prev_pools[lvl - 1], grid + fl,
                                      padding_mode="border")
            warped_cur = grid_sample(pools[lvl - 1], grid - fl,
                                     padding_mode="border")
            feats = [resize_bilinear(label, (size, size), True),
                     pools[lvl - 1]]
            prev_feats = [resize_bilinear(prev_label, (size, size), True),
                          prev_pools[lvl - 1]]
            if net is not None:
                feats.append(net)
                prev_feats.append(prev_net)
            feats.append(warped_prev)
            prev_feats.append(warped_cur)
            dec = getattr(self, f"ConvBlock_{6 + i}")
            up = sp // (2 ** (lvl - 1))
            net = resize_bilinear(dec(torch.cat(feats, 1)), (up, up), True)
            prev_net = resize_bilinear(dec(torch.cat(prev_feats, 1)),
                                       (up, up), True)
        out = self.Conv_0(self.ConvBlock_12(torch.cat([label, net], 1)))
        prev_out = self.Conv_0(self.ConvBlock_12(
            torch.cat([prev_label, prev_net], 1)))
        return out, prev_out
