"""Reference checkpoints -> the port's ``state_dict``s (port of
``jafpro_tpu/torch_compat.py``).

Lets a user of the reference bring its trained checkpoints
(``{Accu,inpaint,bg,refine,pro,D,FD}_iter_<N>.pth``, saved by
``train/4.convLSTM_flowpro_interval.py:514-533`` and read by
``test/conv_pro_test.py:110-141``, and HMR's ``hmr_tf2pt.pth``) into the
port. Each converter maps the reference's keys straight onto the port's
module names (the flax names, as the JAX package's converters lay them
out) in PyTorch's layouts:

- the reference's 24 per-part convs -> one grouped ``PartConv`` weight
  (P*out, in, k, k), the parts' weights stacked part-major, and their
  biases concatenated;
- one conv over concatenated inputs -> several ``PartConv``s, its input
  channels split in the concat order (the bias on the first);
- a ``ConvLSTMCell`` conv over [x, h] with gate chunks (i, f, o, g) ->
  eight per-gate ``PartConv``s ({i,f,o,g}_{x,h}), the bias on the _x conv;
- a ``Linear`` over an NCHW flatten -> a ``Linear`` over the port's NHWC
  flatten (its input columns permuted).

The ``module.`` prefix of ``nn.DataParallel`` is stripped. A key the
converter needs and does not find raises ``KeyError``, and so does a key
left unused, except the ones each converter names as having no place in
the port: the running statistics of norms the port computes from the
batch (propagation, discriminators), HMR's batch counters and its SMPL
buffers (the port's SMPL comes from ``geometry.smpl``). Nothing is
dropped silently.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import torch

from jafpro_tpu_torch.models.parts import ENC_NC

StateDict = Dict[str, torch.Tensor]
# norm statistics of reference BatchNorms that the port's BatchStatsNorm
# recomputes from every batch
_BATCH_STATS = r"\.(running_mean|running_var|num_batches_tracked)$"


class _Reader:
    """A reference ``state_dict`` (a path, or a dict, optionally under
    ``"state_dict"``) with the ``module.`` prefix stripped. Reading a key
    records it; ``finish`` raises on keys left unread that match none of
    ``ignore`` (regexes)."""

    def __init__(self, path_or_sd, ignore: Sequence[str] = ()):
        if isinstance(path_or_sd, (str, os.PathLike)):
            sd = torch.load(path_or_sd, map_location="cpu",
                            weights_only=False)
            sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
        else:
            sd = path_or_sd
        self.sd = {}
        for k, v in sd.items():
            if k.startswith("module."):
                k = k[len("module."):]
            self.sd[k] = torch.as_tensor(v)
        self.used: set = set()
        self.ignore = [re.compile(p) for p in ignore]

    def __call__(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"the reference state_dict has no {key!r}")
        self.used.add(key)
        return self.sd[key].detach().float()

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def finish(self, out: StateDict) -> StateDict:
        left = sorted(k for k in self.sd if k not in self.used
                      and not any(p.search(k) for p in self.ignore))
        if left:
            raise KeyError(f"{len(left)} keys of the reference state_dict "
                           f"have no place in the port: {left[:8]}")
        return {k: v.contiguous() for k, v in out.items()}


def _stack_part_conv(r: _Reader, fmt: str, parts: int) -> StateDict:
    """``fmt`` with one ``{p}`` -> a ``PartConv``'s weight and bias."""
    return {"weight": torch.cat([r(fmt.format(p=p) + ".weight")
                                 for p in range(parts)]),
            "bias": torch.cat([r(fmt.format(p=p) + ".bias")
                               for p in range(parts)])}


def _split_part_conv(r: _Reader, fmt: str, parts: int,
                     in_splits: Sequence[int]) -> list:
    """One reference conv over concatenated inputs -> a ``PartConv`` per
    input, split along input channels at ``in_splits``."""
    ws = [r(fmt.format(p=p) + ".weight") for p in range(parts)]
    bias = torch.cat([r(fmt.format(p=p) + ".bias") for p in range(parts)])
    out, start = [], 0
    for i, c in enumerate(in_splits):
        conv = {"weight": torch.cat([w[:, start:start + c] for w in ws])}
        if i == 0:
            conv["bias"] = bias
        out.append(conv)
        start += c
    return out


def _part_encoder(r: _Reader, fmt: str, parts: int) -> dict:
    """9 stacked ``Downsampler`` convs -> ``PartEncoder``; ``fmt`` e.g.
    'Downsampler_list.{{p}}.enc{n}.enconv.0'."""
    return {f"GroupConvLReLU_{n}": {
        "PartConv_0": _stack_part_conv(r, fmt.format(n=n + 1), parts)}
        for n in range(9)}


def _part_decoder(r: _Reader, dec_fmt: str, head_fmt: str, parts: int,
                  dec_in_splits) -> dict:
    """4 ``Upsampler_SE`` convs and the 3-channel head -> ``PartDecoder``;
    ``dec_in_splits[level]``: the input split of dec{level+1}."""
    tree = {}
    for lvl in range(4):
        convs = _split_part_conv(r, dec_fmt.format(n=lvl + 1), parts,
                                 dec_in_splits[lvl])
        tree[f"GroupConvLReLU_{lvl}"] = {
            f"PartConv_{i}": c for i, c in enumerate(convs)}
    tree["GroupConvLReLU_4"] = {
        "PartConv_0": _stack_part_conv(r, head_fmt, parts)}
    return tree


def _lstm_cell(r: _Reader, prefix: str, parts: int, in_dim: int,
               hidden: int) -> dict:
    """A reference ``ConvLSTMCell``'s fused conv -> eight per-gate
    ``PartConv``s."""
    ws = [r(f"{prefix.format(p=p)}.weight") for p in range(parts)]
    bs = [r(f"{prefix.format(p=p)}.bias") for p in range(parts)]
    tree = {}
    for g, name in enumerate(("i", "f", "o", "g")):
        sl = slice(g * hidden, (g + 1) * hidden)
        tree[f"{name}_x"] = {
            "weight": torch.cat([w[sl, :in_dim] for w in ws]),
            "bias": torch.cat([b[sl] for b in bs])}
        tree[f"{name}_h"] = {
            "weight": torch.cat([w[sl, in_dim:] for w in ws])}
    return tree


def _flat(tree: dict, prefix: str = "") -> StateDict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def load_torch_accumulate(path_or_sd, parts: int = 24) -> StateDict:
    """``Accumulate_LSTM[_no_loss]`` -> ``AccumulateLSTM`` (reference
    ``src/networks.py:1593-1662``, ``Downsampler_convLSTM`` ``:1290-1357``,
    ``convLSTM.py:7-63``)."""
    r = _Reader(path_or_sd)
    tree = {
        "PartEncoder_0": _part_encoder(
            r, "Downsampler_list.{{p}}.enc{n}.enconv.0", parts),
        "PartDecoder_0": _part_decoder(
            r, "Upsampler_list.{{p}}.dec{n}.myconv.0",
            "Upsampler_list.{p}.conv", parts,
            # dec1 [x9(96) | x7(48)], dec2 [48 | x5(24)],
            # dec3 [24 | x3(24)], dec4 [12 | x1(12)]
            [(96, 48), (48, 24), (24, 24), (12, 12)]),
    }
    for lvl in range(5):
        d = ENC_NC[2 * lvl]
        tree[f"lstm{lvl}"] = {"Scan_Cell_0": _lstm_cell(
            r, f"Downsampler_list.{{p}}.convLSTM{lvl + 1}.cell_list.0.conv",
            parts, d, d)}
    return r.finish(_flat(tree))


def load_torch_inpainter(path_or_sd, parts: int = 24) -> StateDict:
    """``UNet_inpainter`` -> ``UNetInpainter`` (reference
    ``src/networks.py:1121-1170, 1805-1828``)."""
    r = _Reader(path_or_sd)
    tree = {
        "PartEncoder_0": _part_encoder(
            r, "Downsampler_list.{{p}}.enc{n}.enconv.0", parts),
        "GroupConvLReLU_0": {"PartConv_0": _stack_part_conv(
            r, "Downsampler_list.{p}.enc_compress.enconv.0", parts)},
        "PartDecoder_0": _part_decoder(
            r, "Upsampler_list.{{p}}.dec{n}.myconv.0",
            "Upsampler_list.{p}.conv", parts,
            # dec1 [x9(96) | global(3P) | x7(48)], then [prev | skip]
            [(96, 3 * parts, 48), (96, 24), (48, 24), (24, 12)]),
    }
    return r.finish(_flat(tree))


def _conv(r: _Reader, prefix: str, bias: bool = True) -> StateDict:
    out = {"weight": r(f"{prefix}.weight")}
    if bias:
        out["bias"] = r(f"{prefix}.bias")
    return out


def _conv_block(r: _Reader, prefix: str) -> dict:
    """A reference CRN ``ConvBlock`` (Sequential [conv, LayerNorm, LReLU]
    twice, ``crn_model.py:90-106``) -> ``ConvBlock``."""
    return {
        "Conv_0": _conv(r, f"{prefix}.conv_block.0"),
        "SampleLayerNorm_0": {"gamma": r(f"{prefix}.conv_block.1.gamma"),
                              "beta": r(f"{prefix}.conv_block.1.beta")},
        "Conv_1": _conv(r, f"{prefix}.conv_block.3"),
        "SampleLayerNorm_1": {"gamma": r(f"{prefix}.conv_block.4.gamma"),
                              "beta": r(f"{prefix}.conv_block.4.beta")},
    }


def load_torch_crn(path_or_sd, fg: bool = False) -> StateDict:
    """``CRN_smaller`` -> ``CRNSmaller`` (reference
    ``src/crn_model.py:243-308``); ``fg`` adds the foreground head."""
    r = _Reader(path_or_sd)
    tree = {}
    for i in range(6):  # encoders 1..6
        tree[f"ConvBlock_{i}"] = _conv_block(r, f"conv{i + 1}_encoder")
    for i, lvl in enumerate(range(6, 0, -1)):  # decoders 6..1
        tree[f"ConvBlock_{6 + i}"] = _conv_block(r, f"conv{lvl}_decoder")
    tree["ConvBlock_12"] = _conv_block(r, "decoder")
    tree["Conv_0"] = _conv(r, "out_conv")
    if fg:
        tree["Conv_1"] = _conv(r, "fg_conv")
    return r.finish(_flat(tree))


def _stats_norm(r: _Reader, prefix: str) -> StateDict:
    """A reference BatchNorm's affine -> ``BatchStatsNorm`` (scale,
    bias); its running statistics have no place in the port."""
    return {"scale": r(f"{prefix}.weight"), "bias": r(f"{prefix}.bias")}


def load_torch_propagation(path_or_sd) -> StateDict:
    """``Propagation3DFlowNet(9, 32, 2, 3, use_deconv=False)`` ->
    ``Propagation3DFlowNet`` (reference ``src/flow_net.py:6-99``).
    Sequential layout for (ngf=32, n_down=2, n_blocks=3): down [pad, conv,
    bn, relu, conv, bn, relu, conv, bn, relu, res, res], res [res], up
    [ups, conv, bn, relu, ups, conv, bn, relu], final [pad, conv, sigmoid];
    ``ResnetBlock.conv_block`` [pad, conv, bn, act, pad, conv, bn]."""
    r = _Reader(path_or_sd, ignore=(_BATCH_STATS,))
    d = "composite_unet.model_down_img"
    res = "composite_unet.model_res_img"
    u = "composite_unet.model_up_img"
    f = "composite_unet.model_final_w"

    def res_block(prefix):
        return {
            "ReflectConv_0": {"Conv_0": _conv(r, f"{prefix}.conv_block.1")},
            "BatchStatsNorm_0": _stats_norm(r, f"{prefix}.conv_block.2"),
            "ReflectConv_1": {"Conv_0": _conv(r, f"{prefix}.conv_block.5")},
            "BatchStatsNorm_1": _stats_norm(r, f"{prefix}.conv_block.6"),
        }

    cw = {
        "ReflectConv_0": {"Conv_0": _conv(r, f"{d}.1")},
        "BatchStatsNorm_0": _stats_norm(r, f"{d}.2"),
        "Conv_0": _conv(r, f"{d}.4"),
        "BatchStatsNorm_1": _stats_norm(r, f"{d}.5"),
        "Conv_1": _conv(r, f"{d}.7"),
        "BatchStatsNorm_2": _stats_norm(r, f"{d}.8"),
        "_ResnetBlock_0": res_block(f"{d}.10"),
        "_ResnetBlock_1": res_block(f"{d}.11"),
        "_ResnetBlock_2": res_block(f"{res}.0"),
        "Conv_2": _conv(r, f"{u}.1"),
        "BatchStatsNorm_3": _stats_norm(r, f"{u}.2"),
        "Conv_3": _conv(r, f"{u}.5"),
        "BatchStatsNorm_4": _stats_norm(r, f"{u}.6"),
        "ReflectConv_1": {"Conv_0": _conv(r, f"{f}.1")},
    }
    return r.finish(_flat({"CompositeWeightUnet_0": cw}))


def _linear_from_nchw(w: torch.Tensor, c: int, h: int,
                      wid: int) -> torch.Tensor:
    """A ``Linear`` weight over an NCHW flatten -> one over the NHWC
    flatten the port's discriminators take."""
    return w.reshape(-1, c, h, wid).permute(0, 2, 3, 1).reshape(w.shape[0],
                                                                -1)


def _dcgan_discriminator(r: _Reader, conv_idx, bn_idx,
                         feat_hw: int) -> StateDict:
    tree = {}
    for i, ci in enumerate(conv_idx):
        blk = {"Conv_0": {"weight": r(f"main.{ci}.weight")}}
        if i > 0:
            blk["BatchStatsNorm_0"] = _stats_norm(r, f"main.{bn_idx[i - 1]}")
        tree[f"_ConvBNLReLU_{i}"] = blk
    c_last = r.sd[f"main.{conv_idx[-1]}.weight"].shape[0]
    tree["_MLPHead_0"] = {
        "Dense_0": {"weight": _linear_from_nchw(
            r("classifier.0.weight"), c_last, feat_hw, feat_hw),
            "bias": r("classifier.0.bias")},
        "Dense_1": _conv(r, "classifier.2"),
    }
    return r.finish(_flat(tree))


def load_torch_image_discriminator(path_or_sd) -> StateDict:
    """``ImageDiscriminator`` (``src/networks.py:356-417``): 6 DCGAN convs
    (256 -> 4 px) and an MLP."""
    return _dcgan_discriminator(
        _Reader(path_or_sd, ignore=(_BATCH_STATS,)),
        conv_idx=(0, 2, 5, 8, 11, 14), bn_idx=(3, 6, 9, 12, 15), feat_hw=4)


def load_torch_face_discriminator(path_or_sd) -> StateDict:
    """``FaceDiscriminator`` (``src/networks.py:419-456``): 4 convs
    (64 -> 4 px) and an MLP."""
    return _dcgan_discriminator(
        _Reader(path_or_sd, ignore=(_BATCH_STATS,)),
        conv_idx=(0, 2, 5, 8), bn_idx=(3, 6, 9), feat_hw=4)


def load_torch_hmr(path_or_sd, num_blocks=(3, 4, 6, 3)) -> StateDict:
    """``HumanModelRecovery`` (e.g. ``hmr_tf2pt.pth``, loaded at
    ``src/cal_flow.py:17-19``) -> ``models.hmr.HumanModelRecovery``. Its
    ``smpl.*`` buffers and batch counters are not read: the port's SMPL
    comes from ``geometry.smpl`` and its batch norms keep no counter."""
    r = _Reader(path_or_sd, ignore=(r"^smpl\.", r"\.num_batches_tracked$"))

    def bn(prefix):
        return {"weight": r(f"{prefix}.weight"), "bias": r(f"{prefix}.bias"),
                "running_mean": r(f"{prefix}.running_mean"),
                "running_var": r(f"{prefix}.running_var"),
                "num_batches_tracked": torch.zeros((), dtype=torch.long)}

    res = {"conv1": _conv(r, "resnet.conv1")}
    for li, n in enumerate(num_blocks):
        for bi in range(n):
            t = f"resnet.layer{li + 1}.{bi}"
            blk = {b: bn(f"{t}.{b}") for b in ("bn1", "bn2", "bn3")}
            blk["conv1"] = _conv(r, f"{t}.conv1", bias=False)
            blk["conv2"] = _conv(r, f"{t}.conv2", bias=False)
            blk["conv3"] = _conv(r, f"{t}.conv3")
            if f"{t}.shortcut.0.weight" in r:
                blk["shortcut"] = _conv(r, f"{t}.shortcut.0")
            res[f"layer{li + 1}_{bi}"] = blk
    res["post_bn"] = bn("resnet.post_bn")
    reg = {"mean_theta": r("regressor.mean_theta")}
    for i in (1, 2, 3):
        reg[f"fc{i}"] = _conv(r, f"regressor.fc_blocks.fc{i}")
    return r.finish(_flat({"resnet": res, "regressor": reg}))


def load_torch_pipeline(pipe: torch.nn.Module, ckpt_dir: str,
                        iteration: int = 42000,
                        names: Optional[Dict[str, str]] = None) -> None:
    """Load the five generation modules of ``pipe`` (a ``JAFProPipeline``)
    the way ``conv_pro_test.py:110-141`` does, from
    ``{Accu,inpaint,bg,refine,pro}_iter_<N>.pth`` in ``ckpt_dir`` (strict).
    ``names`` renames the file stems."""
    n = dict(accu="Accu", inpaint="inpaint", bg="bg", refine="refine",
             pro="pro")
    if names:
        n.update(names)

    def p(stem):
        return os.path.join(ckpt_dir, f"{stem}_iter_{iteration}.pth")

    parts = pipe.cfg.num_parts
    sds = {
        "accu": load_torch_accumulate(p(n["accu"]), parts),
        "inpaint": load_torch_inpainter(p(n["inpaint"]), parts),
        "bg": load_torch_crn(p(n["bg"]), fg=False),
        "refine": load_torch_crn(p(n["refine"]), fg=True),
        "pro": load_torch_propagation(p(n["pro"])),
    }
    for name, sd in sds.items():
        getattr(pipe, name).load_state_dict(sd, strict=True)
