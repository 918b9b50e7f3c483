"""Whole-clip video generation (port of ``jafpro_tpu/infer.py``).

Per clip: accumulate + inpaint the reference textures once, synthesize the
background once, build the texture warp source once, then generate the
frames ``frame_batch`` at a time. Per frame: the propagation source is the
reference frame whose clip index is nearest the target frame; texture warp
through the frame's IUV -> refine -> fuse with the background; the SMPL
flow from that reference's pose to the target pose warps the reference
image; the propagation net (per-sample norm) blends the two.

Frames are independent given the clip's textures, so the result does not
depend on ``frame_batch``; ``flow_mode="batch"`` rasterizes and warps every
frame in one pass up front (one kernel launch per call) instead of per
frame group, with the same output. ``generate_batch`` runs several clips
through every stage together (the JAX package's ``vmap`` over clips); a
single clip is a batch of one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Sequence

import numpy as np
import torch

from jafpro_tpu_torch.data.texture import (
    build_texture_warp_lut, parts_to_atlas, texture_warp_atlas,
    texture_warp_lut)
from jafpro_tpu_torch.geometry.flow import cal_bc_transform
from jafpro_tpu_torch.pipeline import JAFProPipeline, to_nchw
from jafpro_tpu_torch.train.common import normalize_batch


def _encode_u8(x: torch.Tensor) -> torch.Tensor:
    """(-1, 1) -> uint8, the rounding ``frames_to_uint8`` applies."""
    return torch.clamp((x * 0.5 + 0.5) * 255.0, 0, 255).to(torch.uint8)


class _StageClock:
    """Times named stages of one call: CUDA events on a CUDA device, the
    host clock elsewhere. A stage entered more than once adds up."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self.spans.append((name, start, end))

    def totals_ms(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, start, end in self.spans:
            ms = start.elapsed_time(end) if self.cuda else 1e3 * (end - start)
            out[name] = out.get(name, 0.0) + ms
        return out


def _no_clock(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass
class VideoGenerator:
    """``warp_mode``: "lut" warps through the per-clip integer-UV table
    (exact for uint8-valued IUV), "gather" through the 4-tap atlas sample.
    ``output_uint8`` encodes the four outputs to uint8 on the device.
    ``time_stages`` times each stage of a call (CUDA events on the card)
    into ``stage_ms`` (ms per stage, summed over frame groups)."""

    pipe: JAFProPipeline
    frame_batch: int = 1
    flow_mode: str = "scan"   # "scan" | "batch"
    warp_mode: str = "lut"    # "lut" | "gather"
    output_uint8: bool = False
    time_stages: bool = False
    stage_ms: Dict[str, float] = dataclasses.field(
        default_factory=dict, init=False)

    _CLIP_FIELDS = (
        "src_parts", "src_mask_parts", "ref_mask", "bg_incomplete",
        "src_imgs", "chosen_frames", "tgt_iuv255", "tgt_iuv", "smpl_mask",
        "cams", "verts")

    def __post_init__(self):
        if self.flow_mode not in ("scan", "batch"):
            raise ValueError(f"unknown flow_mode {self.flow_mode!r}")
        if self.warp_mode not in ("lut", "gather"):
            raise ValueError(f"unknown warp_mode {self.warp_mode!r}")
        if self.frame_batch < 1:
            raise ValueError("frame_batch must be >= 1")
        if self.pipe.flow_engine is None:
            raise ValueError("the pipeline has no SMPL flow engine")

    def __call__(self, clip) -> Dict[str, torch.Tensor]:
        """clip fields (numpy arrays or tensors, JAX layouts):
          src_parts (1, R, P, p, p, 3), src_mask_parts (1, R, P, p, p),
          ref_mask (1, R), bg_incomplete (1, S, S, 3),
          src_imgs (R, S, S, 3), chosen_frames (R,),
          tgt_iuv255 [/ tgt_iuv] (T, S, S, 3), smpl_mask (T, S, S, 1),
          cams (T, 3), verts (T, V, 3).
        Other fields are ignored. Returns (T, S, S, C) tensors on the
        pipeline's device: final / coarse / mask / tsf."""
        clip = {k: torch.as_tensor(v)[None]
                for k, v in clip.items() if k in self._CLIP_FIELDS}
        return {k: v[0] for k, v in self.generate_batch(clip).items()}

    def generate_batch(self, clips) -> Dict[str, torch.Tensor]:
        """Many clips in one pass: every field of ``clips`` carries a
        leading n_clips axis on the per-clip layout of ``__call__``
        (``stack_clips`` builds it). The texture nets, both CRNs and the
        propagation net see all clips' samples as one batch; with
        ``flow_mode="batch"`` one rasterizer launch covers all n*T poses.
        Returns (n_clips, T, S, S, C) tensors."""
        dev = self.pipe.device
        clips = {k: torch.as_tensor(v, device=dev)
                 for k, v in clips.items() if k in self._CLIP_FIELDS}
        clock = _StageClock(dev) if self.time_stages else _no_clock
        with torch.no_grad():
            result = self._generate(normalize_batch(clips), clock)
        if self.time_stages:
            self.stage_ms = clock.totals_ms()
        return result

    def _generate(self, clip: Dict[str, torch.Tensor], stage):
        pipe = self.pipe
        engine = pipe.flow_engine
        S = pipe.cfg.image_size
        n, T = clip["tgt_iuv255"].shape[:2]
        with stage("accumulate+inpaint"):
            inpainted, _ = pipe.prepare_textures(          # (n, P, p, p, 3)
                clip["src_parts"][:, 0], clip["ref_mask"][:, 0],
                clip["src_mask_parts"][:, 0])
        with stage("background CRN"):
            bg_out = pipe.bg(to_nchw(clip["bg_incomplete"][:, 0]), S)

        chosen = clip["chosen_frames"].long()         # (n, R)
        R = chosen.shape[1]
        src_imgs = to_nchw(clip["src_imgs"].flatten(0, 1))  # (n*R, 3, S, S)
        cams, verts = clip["cams"], clip["verts"]     # (n, T, 3), (n, T, V, 3)
        clip_ids = torch.arange(n, device=chosen.device)[:, None]

        # the n*R source poses need projected face vertices only
        with stage("flow branch"):
            pro_index = torch.clamp(chosen, 0, T - 1)
            src_f2pts_all = engine.project_faces(
                cams[clip_ids, pro_index].flatten(0, 1),
                verts[clip_ids, pro_index].flatten(0, 1))[..., 0:2]
            src_f2pts_all = src_f2pts_all * src_f2pts_all.new_tensor(
                [1.0, -1.0])                          # (n*R, F, 3, 2)

        def nearest_ref(i: torch.Tensor) -> torch.Tensor:
            """Frame ids (f,) -> (n*f,) index of each clip's nearest
            reference into the n*R flattened references, clip-major."""
            r = torch.argmin(torch.abs(i[None, :, None] - chosen[:, None, :]),
                             dim=2)
            return (r + R * clip_ids).flatten()

        def bc_warp(src_pro, fim, wim):
            flow = cal_bc_transform(src_f2pts_all[src_pro], fim, wim)
            return engine.warp_image(src_imgs[src_pro], flow)

        with stage("texture warp"):
            if self.warp_mode == "lut":
                warp_src = build_texture_warp_lut(inpainted)
            else:
                warp_src = parts_to_atlas(inpainted)

        fb = self.frame_batch
        while T % fb:  # largest divisor of T not above frame_batch
            fb -= 1

        def frames(x, t0):
            """Frames t0..t0+fb of every clip, clip-major: (n*fb, ...)."""
            return x[:, t0:t0 + fb].flatten(0, 1)

        frame_ids = torch.arange(T, device=chosen.device)
        if self.flow_mode == "batch":
            with stage("flow branch"):
                _, fim_all, wim_all = engine.render_fim_wim(
                    cams.flatten(0, 1), verts.flatten(0, 1))
                tsf_all = bc_warp(nearest_ref(frame_ids), fim_all, wim_all)
                tsf_all = tsf_all.unflatten(0, (n, T))

        outs = {"final": [], "coarse": [], "mask": [], "tsf": []}
        for t0 in range(0, T, fb):
            i = frame_ids[t0:t0 + fb]
            # a clip's frames stacked along rows share its warp table
            iuv255 = clip["tgt_iuv255"][:, t0:t0 + fb].flatten(1, 2)
            with stage("texture warp"):
                if self.warp_mode == "lut":
                    warped = texture_warp_lut(warp_src, iuv255)
                else:
                    warped = texture_warp_atlas(warp_src, iuv255)
                warped = warped.unflatten(1, (fb, S)).flatten(0, 1)
            with stage("refine CRN+fuse"):
                refined, fg_mask = pipe.refine(to_nchw(warped), S)
                fg = fg_mask.unflatten(0, (n, fb))
                fusion = (refined.unflatten(0, (n, fb)) * fg
                          + bg_out[:, None] * (1.0 - fg)).flatten(0, 1)
            if self.flow_mode == "batch":
                tsf = frames(tsf_all, t0)
            else:
                with stage("flow branch"):
                    _, fim, wim = engine.render_fim_wim(
                        frames(cams, t0), frames(verts, t0))
                    tsf = bc_warp(nearest_ref(i), fim, wim)
            with stage("propagation"):
                out = pipe.pro(fusion, tsf,
                               to_nchw(frames(clip["tgt_iuv"], t0)),
                               to_nchw(frames(clip["smpl_mask"], t0)),
                               per_sample_norm=True)
            outs["final"].append(out["pred_target"])
            outs["coarse"].append(fusion)
            outs["mask"].append(out["weight"])
            outs["tsf"].append(tsf)
        # (n*fb, C, S, S) per group -> (n, T, S, S, C)
        result = {k: torch.cat([x.unflatten(0, (n, fb)) for x in v],
                               dim=1).permute(0, 1, 3, 4, 2)
                  for k, v in outs.items()}
        if self.output_uint8:
            result = {
                "final": _encode_u8(result["final"]),
                "coarse": _encode_u8(result["coarse"]),
                "tsf": _encode_u8(result["tsf"]),
                "mask": torch.clamp(result["mask"] * 255.0, 0, 255).to(
                    torch.uint8),
            }
        return result


def stack_clips(clips: Sequence[dict]) -> Dict[str, np.ndarray]:
    """Per-clip dicts (``load_clip`` / ``ClipPackReader.load`` output) ->
    one dict of the generator's fields with a leading n_clips axis, the
    input of ``VideoGenerator.generate_batch``. The clips must share
    their shapes."""
    out = {}
    for k in VideoGenerator._CLIP_FIELDS:
        if k not in clips[0]:
            continue
        vals = [np.asarray(c[k]) for c in clips]
        if any(v.shape != vals[0].shape for v in vals):
            raise ValueError(
                f"clips differ in {k}: {[v.shape for v in vals]}; only "
                "clips of one shape can share a batch")
        out[k] = np.stack(vals)
    return out


def frames_to_uint8(frames) -> np.ndarray:
    """(-1, 1) floats -> uint8 images on the host; uint8 passes through."""
    x = frames.detach().cpu().numpy() if isinstance(
        frames, torch.Tensor) else np.asarray(frames)
    if x.dtype == np.uint8:
        return x
    return np.clip((x.astype(np.float32) / 2.0 + 0.5) * 255.0,
                   0, 255).astype(np.uint8)
