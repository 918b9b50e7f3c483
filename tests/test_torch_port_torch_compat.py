"""The port's reference-checkpoint converters (``jafpro_tpu_torch.torch_compat``)
against the JAX package's: for each module a seeded ``state_dict`` in the
reference's key layout (the key formats ``jafpro_tpu/torch_compat.py``
reads, the shapes read off the port's module) goes through
``jafpro_tpu.torch_compat.load_torch_*`` then ``bridge.state_dict_from_flax``,
and through the port's converter. The two ``state_dict``s must be equal
exactly (both only move and reshape the same float32 values). A missing
key raises, and so does a key that has no place in the port, except the
ones a converter names (norm statistics the port recomputes, HMR's SMPL
buffers).
"""

import numpy as np
import pytest
import torch

from jafpro_tpu import torch_compat as jtc

from jafpro_tpu_torch import torch_compat as ttc
from jafpro_tpu_torch.bridge import load_jax_params, state_dict_from_flax
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.models.accumulate import AccumulateLSTM
from jafpro_tpu_torch.models.crn import CRNSmaller
from jafpro_tpu_torch.models.discriminators import (
    FaceDiscriminator, ImageDiscriminator)
from jafpro_tpu_torch.models.hmr import HumanModelRecovery
from jafpro_tpu_torch.models.inpainter import UNetInpainter
from jafpro_tpu_torch.models.propagation import Propagation3DFlowNet
from jafpro_tpu_torch.pipeline import JAFProPipeline

torch.set_num_threads(1)
P = 3  # parts: the converters take any count


class RefSD(dict):
    """A reference-layout state_dict filled with seeded values."""

    def __init__(self, seed, parts=P):
        super().__init__()
        self.rng = np.random.RandomState(seed)
        self.parts = parts

    def put(self, key, shape):
        self[key] = torch.from_numpy(
            self.rng.uniform(-1, 1, shape).astype(np.float32))

    def conv(self, prefix, w, bias=True):
        """A reference conv shaped as the port's weight ``w`` (OIHW)."""
        self.put(f"{prefix}.weight", tuple(w.shape))
        if bias:
            self.put(f"{prefix}.bias", (w.shape[0],))

    def bn(self, prefix, c, stats=True):
        self.put(f"{prefix}.weight", (c,))
        self.put(f"{prefix}.bias", (c,))
        if stats:   # a torch BatchNorm2d's buffers
            self.put(f"{prefix}.running_mean", (c,))
            self[f"{prefix}.running_var"] = torch.from_numpy(
                self.rng.uniform(0.5, 1.5, c).astype(np.float32))
            self[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    def part_conv(self, fmt, convs):
        """One reference conv per part (``fmt`` with ``{p}``) whose input
        channels are the port's ``PartConv``s' (in order)."""
        P = self.parts
        out, k = convs[0].weight.shape[0] // P, convs[0].weight.shape[2]
        cin = sum(c.weight.shape[1] for c in convs)
        for p in range(P):
            self.put(fmt.format(p=p) + ".weight", (out, cin, k, k))
            self.put(fmt.format(p=p) + ".bias", (out,))


def part_convs(group):
    return [m for n, m in group.named_children() if n.startswith("PartConv_")]


def encoder_decoder(sd, enc, dec):
    for n in range(9):
        sd.part_conv(f"Downsampler_list.{{p}}.enc{n + 1}.enconv.0",
                     part_convs(getattr(enc, f"GroupConvLReLU_{n}")))
    for lvl in range(4):
        sd.part_conv(f"Upsampler_list.{{p}}.dec{lvl + 1}.myconv.0",
                     part_convs(getattr(dec, f"GroupConvLReLU_{lvl}")))
    sd.part_conv("Upsampler_list.{p}.conv",
                 part_convs(dec.GroupConvLReLU_4))


def ref_accumulate(m, seed, parts=P):
    sd = RefSD(seed, parts)
    encoder_decoder(sd, m.PartEncoder_0, m.PartDecoder_0)
    for lvl in range(5):
        cell = getattr(m, f"lstm{lvl}").Scan_Cell_0
        hid, cin, k = (cell.i_x.weight.shape[0] // parts,
                       cell.i_x.weight.shape[1], cell.i_x.weight.shape[2])
        for p in range(parts):
            pre = f"Downsampler_list.{p}.convLSTM{lvl + 1}.cell_list.0.conv"
            sd.put(f"{pre}.weight", (4 * hid, cin + hid, k, k))
            sd.put(f"{pre}.bias", (4 * hid,))
    return sd


def ref_inpainter(m, seed, parts=P):
    sd = RefSD(seed, parts)
    encoder_decoder(sd, m.PartEncoder_0, m.PartDecoder_0)
    sd.part_conv("Downsampler_list.{p}.enc_compress.enconv.0",
                 part_convs(m.GroupConvLReLU_0))
    return sd


def ref_crn(m, seed):
    sd = RefSD(seed)
    prefixes = ([f"conv{i}_encoder" for i in range(1, 7)]
                + [f"conv{i}_decoder" for i in range(6, 0, -1)] + ["decoder"])
    for i, pre in enumerate(prefixes):
        blk = getattr(m, f"ConvBlock_{i}")
        for j, (conv, norm) in enumerate(((0, 1), (3, 4))):
            sd.conv(f"{pre}.conv_block.{conv}", getattr(blk, f"Conv_{j}").weight)
            c = getattr(blk, f"Conv_{j}").weight.shape[0]
            sd.put(f"{pre}.conv_block.{norm}.gamma", (c,))
            sd.put(f"{pre}.conv_block.{norm}.beta", (c,))
    sd.conv("out_conv", m.Conv_0.weight)
    if hasattr(m, "Conv_1"):
        sd.conv("fg_conv", m.Conv_1.weight)
    return sd


def ref_propagation(m, seed):
    sd = RefSD(seed)
    cw = m.CompositeWeightUnet_0
    d, r, u, f = (f"composite_unet.model_{s}" for s in
                  ("down_img", "res_img", "up_img", "final_w"))
    convs = [("ReflectConv_0.Conv_0", f"{d}.1"), ("Conv_0", f"{d}.4"),
             ("Conv_1", f"{d}.7"), ("Conv_2", f"{u}.1"), ("Conv_3", f"{u}.5"),
             ("ReflectConv_1.Conv_0", f"{f}.1")]
    norms = [("BatchStatsNorm_0", f"{d}.2"), ("BatchStatsNorm_1", f"{d}.5"),
             ("BatchStatsNorm_2", f"{d}.8"), ("BatchStatsNorm_3", f"{u}.2"),
             ("BatchStatsNorm_4", f"{u}.6")]
    for i, pre in enumerate((f"{d}.10", f"{d}.11", f"{r}.0")):
        convs += [(f"_ResnetBlock_{i}.ReflectConv_0.Conv_0",
                   f"{pre}.conv_block.1"),
                  (f"_ResnetBlock_{i}.ReflectConv_1.Conv_0",
                   f"{pre}.conv_block.5")]
        norms += [(f"_ResnetBlock_{i}.BatchStatsNorm_0", f"{pre}.conv_block.2"),
                  (f"_ResnetBlock_{i}.BatchStatsNorm_1", f"{pre}.conv_block.6")]
    for path, pre in convs:
        sd.conv(pre, cw.get_submodule(path).weight)
    for path, pre in norms:
        sd.bn(pre, cw.get_submodule(path).scale.shape[0])
    return sd


def ref_discriminator(m, seed, conv_idx, bn_idx):
    sd = RefSD(seed)
    for i, ci in enumerate(conv_idx):
        blk = getattr(m, f"_ConvBNLReLU_{i}")
        sd.conv(f"main.{ci}", blk.Conv_0.weight, bias=False)
        if i:
            sd.bn(f"main.{bn_idx[i - 1]}", blk.Conv_0.weight.shape[0])
    sd.conv("classifier.0", m._MLPHead_0.Dense_0.weight)
    sd.conv("classifier.2", m._MLPHead_0.Dense_1.weight)
    return sd


def ref_hmr(m, seed, num_blocks):
    sd = RefSD(seed)
    res = m.resnet
    sd.conv("resnet.conv1", res.conv1.weight)
    for li, n in enumerate(num_blocks):
        for bi in range(n):
            blk = getattr(res, f"layer{li + 1}_{bi}")
            t = f"resnet.layer{li + 1}.{bi}"
            for b in ("bn1", "bn2", "bn3"):
                sd.bn(f"{t}.{b}", getattr(blk, b).weight.shape[0])
            sd.conv(f"{t}.conv1", blk.conv1.weight, bias=False)
            sd.conv(f"{t}.conv2", blk.conv2.weight, bias=False)
            sd.conv(f"{t}.conv3", blk.conv3.weight)
            if hasattr(blk, "shortcut"):
                sd.conv(f"{t}.shortcut.0", blk.shortcut.weight)
    sd.bn("resnet.post_bn", res.post_bn.weight.shape[0])
    sd.put("regressor.mean_theta", tuple(m.regressor.mean_theta.shape))
    for i in (1, 2, 3):
        sd.conv(f"regressor.fc_blocks.fc{i}",
                getattr(m.regressor, f"fc{i}").weight)
    sd.put("smpl.v_template", (5, 3))   # SMPL buffers the port does not read
    return sd


def module_cases():
    hb = (1, 1, 2, 1)
    return {
        "accumulate": (lambda: AccumulateLSTM(P), ref_accumulate,
                       lambda sd: jtc.load_torch_accumulate(sd, P),
                       lambda sd: ttc.load_torch_accumulate(sd, P)),
        "inpainter": (lambda: UNetInpainter(P), ref_inpainter,
                      lambda sd: jtc.load_torch_inpainter(sd, P),
                      lambda sd: ttc.load_torch_inpainter(sd, P)),
        "crn": (lambda: CRNSmaller(fg=False), ref_crn,
                jtc.load_torch_crn, ttc.load_torch_crn),
        "crn_fg": (lambda: CRNSmaller(fg=True), ref_crn,
                   lambda sd: jtc.load_torch_crn(sd, fg=True),
                   lambda sd: ttc.load_torch_crn(sd, fg=True)),
        "propagation": (Propagation3DFlowNet, ref_propagation,
                        jtc.load_torch_propagation,
                        ttc.load_torch_propagation),
        "image_d": (ImageDiscriminator,
                    lambda m, s: ref_discriminator(
                        m, s, (0, 2, 5, 8, 11, 14), (3, 6, 9, 12, 15)),
                    jtc.load_torch_image_discriminator,
                    ttc.load_torch_image_discriminator),
        "face_d": (FaceDiscriminator,
                   lambda m, s: ref_discriminator(m, s, (0, 2, 5, 8),
                                                  (3, 6, 9)),
                   jtc.load_torch_face_discriminator,
                   ttc.load_torch_face_discriminator),
        "hmr": (lambda: HumanModelRecovery(num_blocks=hb, device="cpu"),
                lambda m, s: ref_hmr(m, s, hb),
                lambda sd: jtc.load_torch_hmr(sd, hb),
                lambda sd: ttc.load_torch_hmr(sd, hb)),
    }


@pytest.mark.parametrize("name", sorted(module_cases()))
def test_converter_equals_jax_then_bridge(name):
    make, ref, jload, tload = module_cases()[name]
    module = make()
    sd = ref(module, len(name))
    want = state_dict_from_flax(jload(dict(sd)), module)
    got = tload(dict(sd))
    assert set(got) == set(want) == set(module.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    module.load_state_dict(got, strict=True)

    # the DataParallel prefix is stripped
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    assert all(torch.equal(a, got[k]) for k, a in tload(prefixed).items())
    # a missing key raises; so does one with no place in the port
    key = next(k for k in sd if k.endswith(".weight"))
    with pytest.raises(KeyError, match="has no"):
        tload({k: v for k, v in sd.items() if k != key})
    with pytest.raises(KeyError, match="no place in the port"):
        tload({**sd, "extra_head.weight": torch.zeros(2)})


def test_load_torch_pipeline_matches_jax(tmp_path):
    """The five generation modules from ``<stem>_iter_<N>.pth`` files (one
    saved under ``state_dict`` with the DataParallel prefix, as the
    reference's trainer may), against the JAX package's
    ``load_torch_pipeline`` bridged into a second pipeline."""
    # the JAX package's load_torch_pipeline takes the reference's 24 parts
    cfg = Config(image_size=64, part_size=16, num_parts=24, num_faces=0,
                 compute_dtype="float32")
    pipe = JAFProPipeline(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    refs = {"Accu": ref_accumulate(pipe.accu, 1, 24),
            "inpaint": ref_inpainter(pipe.inpaint, 2, 24),
            "bg": ref_crn(pipe.bg, 3), "refine": ref_crn(pipe.refine, 4),
            "pro": ref_propagation(pipe.pro, 5)}
    for stem, sd in refs.items():
        obj = dict(sd) if stem != "bg" else {
            "state_dict": {f"module.{k}": v for k, v in sd.items()}}
        torch.save(obj, tmp_path / f"{stem}_iter_9.pth")
    ttc.load_torch_pipeline(pipe, str(tmp_path), iteration=9)
    other = JAFProPipeline(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    load_jax_params(other, jtc.load_torch_pipeline(str(tmp_path), 9))
    for name in ("accu", "inpaint", "bg", "refine", "pro"):
        a = getattr(pipe, name).state_dict()
        b = getattr(other, name).state_dict()
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    with pytest.raises(FileNotFoundError):
        ttc.load_torch_pipeline(pipe, str(tmp_path), iteration=10)
