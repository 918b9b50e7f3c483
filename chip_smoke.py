#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``jafpro_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (nothing is caught):

1. Environment: torch/CUDA versions, ``nvcc --version``, the card's name
   and power limit; needs one Hopper card (compute capability 9.0).
2. Build: compile every native source of ``jafpro_tpu_torch/csrc/`` at
   once, one compiler process each: ``rasterizer.cu``,
   ``correlation.cu`` and ``norm.cu`` with nvcc, the shard reader
   ``shardio.cc`` with g++.
3. Kernel vs plain version on the card: random scenes (back faces, faces
   crossing near and far, coplanar z-fighting pairs, degenerate faces, a
   face count that is not a multiple of 256), the full 30-frame,
   13776-face clip mesh with its faces in the mesh's own (banded) order
   and in a seeded random order, and a scene of points, collinear faces,
   near-collinear slivers (also alone in blocks whose box ends at a tile
   border) and faces crossing near and far at 256x256.
   Face ids must be equal and weights within 1e-5. The kernel (on both
   face orders), its plain version and the data-dependent bound are
   timed; the faces the kernel's cull keeps per tile are counted with
   its plain form (``face_tile_keep``).
4. Reference: a small clip through the generator on the card and on the
   CPU (where the rasterizer is the plain version) must agree within 1e-3.
5. The slice at full width: ``Config()`` widths in float32 (TF32 off),
   4 refs, 30 frames at 256x256, 24 parts of 200 px, a closed mesh with
   SMPL's counts (V = 6890, F = 13776), random weights from a seeded
   ``torch.Generator``. Drives ``VideoGenerator`` end to end with the
   kernel's launch count reset before and read after; checks shapes,
   finiteness, that the flow branch saw the mesh, and that the per-frame
   schedule gives the same video; reports warm frames/s, peak memory and,
   from one more clip with the generator's stage clock on, the device
   time of each stage. Then the same clip in bfloat16 (the ``Config``
   default): checked outputs, frames/s and the distance from float32.
6. Serve and score: four seeded full-width clips packed by the writer
   behind ``pack --kind clips`` (``shardio.write_clip_pack``) into a
   temporary directory (removed at the end), read back with
   ``ClipPackReader`` and served as ``cli infer --packed-clips`` serves
   them (``cli.serve``, ``cli.serving_generator``: uint8 on the card, two
   overlapping batches of n = 2) with a writer that keeps the fetched
   frames (``cli.fetch_clips``) in memory, since the card machine has no
   ``cv2``. Served in float32 (TF32 off) and in the CLI's default
   bfloat16, each first and warm. The rasterizer must launch exactly once
   per batch; each served clip must equal the same generator on that
   clip alone within 1 uint8 step; a float32 batch must equal per-clip
   generation within 1e-4. Reports clips/s, the load, compute and write
   ms per batch and peak memory; then scores two clips' final frames
   against their coarse frames with ``evaluate_video`` and both deep
   metrics (seeded VGG19 and FlowNetSD) on the card, under PyTorch's
   default TF32 settings as ``cli evaluate`` runs, held to the same call
   on the CPU within 1e-3 relative.

7. Train: seeded full-width records (4 refs, 24 parts of 200 px, 256x256,
   the phase-3 mesh's vertices) packed with ``shardio.pack_shard`` into a
   temporary directory (removed at the end): 8 textonly records for
   stages 1-2 and 8 interval records for stages 3-4. Each stage reads them
   through ``ShardReader`` as ``cli train --shards`` does
   (``cli._raw_batch_source``, the host curriculum, the copy to the card)
   and takes 1 warm-up and 3 timed steps at ``Config()`` widths and the
   CLI's batch (4; 2 for stage 2) in bfloat16, the CLI's default; stage 4
   once more in float32 with TF32 off. Reports s/step (median of 3),
   samples/s and peak memory; checks finite losses, that exactly the
   trained modules moved (``bg`` bitwise unchanged in stage 4) and that
   each stage-4 step launched the rasterizer kernel once, on the batch's
   4 target poses. Then one stage-1 and one stage-4 step with SGD at
   64 px (parts of 16, 2 refs, float32, TF32 off) from the same
   seeded weights on the card and on the CPU (stage 4 at batch 4, see
   ``TRAIN_REF_BATCH``): losses and each module's update held to a
   stated tolerance.

8. The body path: ``HumanModelRecovery`` (full ResNet50 depth) on 30
   seeded 224x224 images in float32 (TF32 off) and bfloat16 with
   ``get_details`` on its theta; ``SMPLModel`` at SMPL's sizes on the
   phase-3 sphere (seeded blend shapes and weights) for 30 seeded
   moderate poses; ``SMPLRenderer`` at 256x256, T = 3, on those meshes:
   ``render_depth`` (the kernel's depth output), ``extract_tex_from_image``,
   ``render`` with lighting and ``render_silhouettes(edge_gradients=True)``
   with a backward to the vertices and camera. Checks shapes, finiteness
   and one kernel launch per rasterizing call; reports each step's ms
   (median of 3) and peak memory. Then the same path at 64x64 on 2 poses
   on the card and on the CPU: HMR theta within 1e-4 relative, SMPL
   vertices 1e-5, rendered images 1e-4, vertex gradients 1e-3 relative L2.

9. The flow path: the correlation kernels (``csrc/correlation.cu``,
   forward and backward) against the plain version on FlowNetC's
   training shape (8, 256, 32, 32), a 384x1024 Sintel crop's (2, 256, 48,
   128), an odd (1, 256, 13, 29), all at md 20, s2 2, (2, 256, 32, 32)
   at md 4, s2 1, a ragged (3, 72, 20, 70) at md 8, s2 2 (C and W not
   multiples of the kernel's tiles) and a wide (2, 2085, 12, 40) at md
   20, s2 2 (f1's row too large to stay in shared memory), in float32
   (forward 1e-5 absolute, gradients 1e-5 relative L2) and bfloat16
   (within twice the plain bfloat16 form's own error against float32),
   each with the source's launch plan equal to ``launch_plan``'s; their
   median ms and the plain form's beside the bound and its share (and the
   forward at FlowNet2's clip shape, 29 pairs). Then the harness
   (``make_flow_train_step``) trains FlowNetC and FlowNetSD at batch 8 on
   256² synthetic batches in float32 (TF32 off) and bfloat16, 1 warm-up
   and 3 timed steps each: finite loss and EPE, parameters that move, s/step, samples/s, peak memory and the
   correlation launches of each step (FlowNetC: 1 forward, 1 backward;
   FlowNetSD: none). FlowNet2 (float32) then runs the 29 pairs of a
   seeded 30-frame 256² clip in one batch (ms per clip, 1 launch). Last,
   FlowNetC at 64² on the card and on the CPU: the forward within 1e-4
   relative and one SGD harness step within 1e-5 on loss and EPE and 5e-3
   on each module's update (at batch 4, see ``FLOW_REF_BATCH``).

10. The ablation zoo: every module of ``models/ablations.py`` and the
   recurrence and CRN forms beside them (``ConvLSTM``, ``ConvGRU`` with
   both cells, ``CRN``, ``CRNSmall``, ``AccumulateGRU`` with both cells),
   one forward each at its reference width in float32 (TF32 off), batch 1,
   from seeded weights: 256² images, the 800x1200 atlas for ``UNetTA``,
   (1, 4, 24, 200, 200, 3) part stacks for the fusions and
   ``MaxFusionModule``, ``SpatioTempoCRN`` at ngf 512, ``RRDB`` at 64
   features, growth 32, 128², the recurrences at hidden 64, 64², T = 4.
   Checks shapes and finite outputs; reports the median ms of 3 after a
   warm-up and the peak memory; runs ``EdgeGenerator`` and
   ``PatchDiscriminator70`` once more with ``update_sn=True`` and checks
   that every ``u`` and ``sigma`` moved. Then every module at a small size
   from the same seeded weights on the card and on the CPU: outputs within
   1e-4 of the largest, the spectral-norm nets' updated ``u`` and
   ``sigma`` within 1e-5. No module of the zoo launches a kernel of
   ``csrc/``.

11. Data parallelism (``jafpro_tpu_torch/parallel``): ranks started with
   ``parallel.spawn`` (a ``file://`` rendezvous in a temporary directory,
   removed at the end; the ranks load phase 2's builds). (a) NCCL at world
   1 on the card: one stage-4 SGD step at 64 px (phase 7's set-up, global
   batch 4 whose last face box is empty) through ``data_parallel_jit``
   against the same step without a mesh. (b) Two gloo ranks sharing the
   card: the stage-1 and stage-4 steps at global batch 4 (2 per rank)
   against one process at batch 4; replicas bitwise equal, metrics equal
   on both ranks, the rasterizer once per rank per stage-4 step on its 2
   poses. Both within ``TRAIN_METRIC_RTOL`` / ``TRAIN_UPDATE_RTOL``. (c)
   Stage 4 at ``Config()`` widths in bfloat16, global batch 4 as 2 ranks x
   2 on the one card, from phase 7's packed interval records through the
   shard reader (``cli._raw_batch_source``), 1 warm-up and 3 timed steps:
   finite losses, exactly the trained modules moved (``bg`` bitwise
   unchanged), replicas bitwise equal, one launch per rank per step;
   per-rank s/step and peak memory (two ranks share one card: a
   correctness run, not a scaling number). (d) Phase 6's four clips served
   by the 2 ranks (``cli.serve_share``, one clip per batch, frames kept in
   memory), one launch per batch per rank, in bfloat16 (the CLI's dtype)
   and in float32: each served clip must be within 1 uint8 step of phase
   6's one process on that clip alone (in bfloat16 served alone through
   the same serving path, one clip per batch: the call form ``gen(clip)``
   hands the generator the same values with other strides on its size-1
   axes, and in bfloat16 that alone moves a frame by several steps); then
   ``generate_batch(clips, mesh)`` of two clips in float32 (one per rank)
   against per-clip generation within 1e-4. (e) With two or more cards,
   (b) over NCCL, one card per rank; with one, a line says it was not
   run.
12. The ConvBlock norm (``csrc/norm.cu``, ``ops/norm.py``): the 26
   ``SampleLayerNorm`` inputs of one refine-CRN forward over a served clip's
   30 frames and of one background-CRN forward over 1 image, in bfloat16
   (recorded from ``CRNSmaller`` on a channels-last label, as the generator
   hands it over), each through the kernels and through the plain form:
   the rounded pre-activation within one bfloat16 ulp (values under 1/64
   taken at 1/64), the output the LeakyReLU of the kernels' own
   pre-activation bit for bit, 26 ``nets.norm`` spans in a traced forward
   of each; the kernels' time per
   clip against the plain form's and the bytes bound (each input read
   once, each output written once, at 3.35 TB/s). Then the 26 inputs of a
   stage-4 step's refine CRN (4 frames, under autograd), forward and
   backward through the kernels against autograd of the plain form: dx
   within 1e-2 relative L2, dgamma and dbeta within 1e-3. The kernels'
   record is ``sample_norm`` in the kernels line, with the kernel launches
   of phase 5's clip (2 a call, 52 calls: 26 a CRN) and of one bfloat16
   stage-4 step of phase 7, forward and backward; phase 6 checks 104 a
   served batch and none backward.

Phase 3 also runs the kernel with its depth output on every scene (depth
within 1e-6 relative of the plain version's, 0 at background; whether it
is bitwise is printed), checks the gradient's recompute of weights and
depth (``winner_weights_depth``) against the kernel's, and times the
kernel with and without the depth output in turns.

Prints the kernels' JSON line (the rasterizer, the correlation and its
backward; the correlation's ``bound_ms`` is the larger of its bytes time
and the lower of its two operation times, FP32 on the CUDA cores or
3xTF32 on the tensor cores, ``bound_rate`` naming the one taken), the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12
OPS_PER_PAIR = 40  # fp32 operations per (pixel, face) test in the kernel
KERNEL_SOURCE = "jafpro_tpu_torch/csrc/rasterizer.cu"
KERNEL_REPLACES = "jafpro_tpu/geometry/rasterizer_pallas.py:123"
CORR_SOURCE = "jafpro_tpu_torch/csrc/correlation.cu"
CORR_REPLACES = "jafpro_tpu/ops/correlation.py:19"
# every source under csrc/, built together in phase 2
NORM_SOURCE = "jafpro_tpu_torch/csrc/norm.cu"
NATIVE_SOURCES = ("rasterizer.cu", "correlation.cu", "norm.cu", "shardio.cc")
# PyTorch's own TF32 settings, those the CLI runs under
TF32_DEFAULTS = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs a GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (9, 0), got {cap}")
    from jafpro_tpu_torch.cuda_build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    card = smi_name_power()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[env] nvcc: {nvcc.strip().splitlines()[-1]}")
    log(f"[env] card: {card}; devices {torch.cuda.device_count()}")
    # float32 means float32: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[env] cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    return card


def phase_build() -> float:
    """Build every native source at once, one compiler process each;
    returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from jafpro_tpu_torch import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(NATIVE_SOURCES)) as pool:
        built = list(pool.map(cuda_build.build, NATIVE_SOURCES))
    secs = time.perf_counter() - t0
    for source, (path, s, out) in zip(NATIVE_SOURCES, built):
        for line in out.strip().splitlines():
            log(f"[build] {source}: {line}")
        log(f"[build] {path} in {s:.2f} s")
        cuda_build.load(source)
    log(f"[build] {len(NATIVE_SOURCES)} sources in parallel: {secs:.2f} s")
    return secs


def random_scene(rng: np.random.RandomState, n_faces: int) -> np.ndarray:
    """Random triangles with the hard cases mixed in."""
    centers = rng.uniform(-0.9, 0.9, (n_faces, 1, 3))
    fv = (centers + rng.uniform(-0.2, 0.2, (n_faces, 3, 3))).astype(
        np.float32)
    fv[:, :, 2] = rng.uniform(1.0, 6.0, (n_faces, 3))
    k = n_faces // 10
    fv[:k, :, 2] = np.float32([0.05, 0.4, 0.2])           # crosses near
    fv[k:2 * k, :, 2] = np.float32([20.0, 31.0, 24.0])    # crosses far
    fv[2 * k:3 * k] = fv[2 * k:3 * k, ::-1]               # back faces
    fv[3 * k:4 * k, 1:] = fv[3 * k:4 * k, :1]             # points
    fv[4 * k:5 * k, 2] = 0.5 * (fv[4 * k:5 * k, 0] + fv[4 * k:5 * k, 1])
    fv[5 * k:6 * k, :, 2] = 3.0                           # coplanar ...
    fv[6 * k:7 * k] = fv[5 * k:6 * k] + np.float32(0.03)  # ... overlaps
    fv[6 * k:7 * k, :, 2] = 3.0
    fv[7 * k:8 * k] = fv[:k]                              # duplicates
    return fv[rng.permutation(n_faces)]


def cuda_time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bbox_pairs(face_verts: torch.Tensor, S: int) -> int:
    """(pixel, face) pairs an exact z-buffer must test on this data: pixel
    centres inside each front face's bounding box."""
    x, y = face_verts[..., 0], face_verts[..., 1]
    front = (y[..., 2] - y[..., 0]) * (x[..., 1] - x[..., 0]) >= (
        (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))

    def span(v):
        lo = torch.ceil((v.amin(-1) * S + S - 1) / 2).clamp(0, S)
        hi = torch.floor((v.amax(-1) * S + S - 1) / 2).clamp(-1, S - 1)
        return (hi - lo + 1).clamp(min=0)

    return int((span(x) * span(y) * front).sum().item())


def survivor_stats(prep, fim: torch.Tensor, S: int) -> dict:
    """Faces the kernel tests per 16x16 tile (``face_tile_keep``): mean and
    max over body tiles (tiles with a covered pixel), and the (pixel, face)
    pairs tested over the whole batch."""
    from jafpro_tpu_torch.geometry import rasterizer as R

    keep = R.face_tile_keep(prep, S).sum(-1)                 # (B, Ty, Tx)
    t = R.TILE
    n = keep.shape[1]
    cov = torch.zeros(fim.shape[0], n * t, n * t, dtype=torch.bool,
                      device=fim.device)
    cov[:, :S, :S] = torch.flip(fim, dims=[1]) >= 0         # unflipped rows
    body = cov.reshape(-1, n, t, n, t).any(4).any(2)
    rows = torch.clamp(S - t * torch.arange(n, device=fim.device), max=t)
    pix = rows[:, None] * rows[None, :]                      # tile pixels
    per_body = keep[body].float()
    return {"mean": float(per_body.mean()), "max": int(per_body.max()),
            "pairs": int((keep * pix).sum())}


def compare_kernel(face_verts: torch.Tensor, S: int, what: str) -> dict:
    """The kernel with its depth output off and on against the plain
    version: face ids equal, weights within 1e-5, depth within 1e-6
    relative (the same arithmetic; whether it is bitwise is logged); and
    the weights and depth ``winner_weights_depth`` recomputes for the
    gradient against the kernel's (1e-5, 1e-6 relative)."""
    from jafpro_tpu_torch.geometry import rasterizer as R

    prep = R.prepare_faces(face_verts, S)
    fim, wim = R.rasterize_prepared_cuda(prep, S, 0.1, 25.0)
    dfim, dwim, dim = R.rasterize_prepared_cuda(prep, S, 0.1, 25.0,
                                                return_depth=True)
    rfim, rwim, rdim = R.rasterize_prepared_reference(prep, S, 0.1, 25.0,
                                                      return_depth=True)
    gw, gd = R.winner_weights_depth(face_verts, dfim, S)
    torch.cuda.synchronize()
    mismatch = int((fim != rfim).sum().item()) + int(
        (dfim != rfim).sum().item())
    werr = max(float((wim - rwim).abs().max().item()),
               float((dwim - rwim).abs().max().item()))
    found = rfim >= 0
    denom = rdim.abs().clamp(min=1e-30)
    derr = float(((dim - rdim).abs() / denom)[found].max().item())
    bg_ok = bool((dim[~found] == 0).all().item())
    bitwise = bool(torch.equal(dim, rdim))
    gwerr = float((gw - dwim).abs().max().item())
    gderr = float(((gd - dim).abs() / denom)[found].max().item())
    cover = float(found.float().mean().item())
    log(f"[kernel] {what}: B={face_verts.shape[0]} F={face_verts.shape[1]} "
        f"S={S} fim_mismatch={mismatch} wim_max_abs={werr:.3e} "
        f"depth_max_rel={derr:.3e} depth_bitwise={bitwise} "
        f"recompute wim_max_abs={gwerr:.3e} depth_max_rel={gderr:.3e} "
        f"coverage={cover:.3f}")
    if mismatch or not werr <= 1e-5:
        raise AssertionError(f"kernel disagrees with plain version ({what})")
    if not (derr <= 1e-6 and bg_ok):
        raise AssertionError(f"kernel depth disagrees with plain version "
                             f"({what})")
    if not (gwerr <= 1e-5 and gderr <= 1e-6):
        raise AssertionError(f"the gradient's recompute disagrees with the "
                             f"kernel ({what})")
    if cover <= 0.01:
        raise AssertionError(f"scene {what} covers no pixels")
    return {"prep": prep, "fim": fim, "fim_mismatch": mismatch,
            "wim_max_abs": werr, "depth_max_rel": derr,
            "depth_bitwise": bitwise}


def make_clip(seed: int, T: int, R: int, S: int, p: int, P: int):
    """A clip shaped like ``bench.py``'s, on a closed mesh with SMPL's
    vertex and face counts (an upright ellipsoid at z = 2, jittered per
    frame), and IUV part ids confined to the body's columns."""
    from jafpro_tpu_torch.geometry.projection import project_to_view_np
    from jafpro_tpu_torch.utils.meshproxy import ellipsoid_clip

    verts, cams, faces = ellipsoid_clip(T, seed)
    rng = np.random.RandomState(seed)
    iuv = np.zeros((T, S, S, 3), np.float32)
    iuv[..., 0] = rng.randint(0, P + 1, (T, S, S))
    iuv[..., 1:] = rng.randint(0, 256, (T, S, S, 2))
    view = project_to_view_np(verts, cams)
    px = 0.5 * (view[..., 0] * S + S - 1)
    lo = max(int(np.floor(px.min())) - 1, 0)
    hi = min(int(np.ceil(px.max())) + 1, S - 1)
    body = np.zeros((S,), np.float32)
    body[lo:hi + 1] = 1.0
    iuv[..., 0] *= body[None, None, :]
    clip = {
        "src_parts": rng.uniform(-1, 1, (1, R, P, p, p, 3)),
        "src_mask_parts": rng.rand(1, R, P, p, p) > 0.5,
        "ref_mask": np.ones((1, R)),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)),
        "src_imgs": rng.uniform(-1, 1, (R, S, S, 3)),
        "tgt_iuv255": iuv,
        "tgt_iuv": (iuv / 255.0 - 0.5) * 2.0,
        "smpl_mask": np.ones((T, S, S, 1)),
        "cams": cams,
        "verts": verts,
    }
    clip = {k: np.asarray(v, np.float32) for k, v in clip.items()}
    clip["chosen_frames"] = np.linspace(0, T - 1, R).round().astype(np.int32)
    return clip, faces


def phase_kernel(seed: int, clip: dict, faces: np.ndarray, S: int,
                 dev: torch.device, card: str) -> dict:
    """Kernel vs plain version on every phase-3 scene; kernel times on both
    face orders of the clip mesh, the plain time, the bound and the faces
    the cull keeps per tile. Returns the kernel's keys of the JSON line
    that ``main`` does not know."""
    from jafpro_tpu_torch.geometry import rasterizer as R
    from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
    from jafpro_tpu_torch.utils.meshproxy import ellipsoid_clip, sliver_scene

    rng = np.random.RandomState(seed)
    for i, (n, s) in enumerate(((1000, 256), (3001, 256), (517, 100))):
        fv = np.stack([random_scene(rng, n) for _ in range(2)])
        compare_kernel(torch.from_numpy(fv).to(dev), s, f"random scene {i}")
    cams = torch.from_numpy(clip["cams"]).to(dev)
    verts = torch.from_numpy(clip["verts"]).to(dev)
    # the mesh's own face order (ring by ring), and a seeded random order
    shuffled = ellipsoid_clip(clip["verts"].shape[0], seed, shuffle=True)[2]
    fv_clip, fv_shuf = (
        SMPLFlowEngine(faces=f, image_size=S).project_faces(
            cams, verts).contiguous() for f in (faces, shuffled))
    fv_sliver = torch.from_numpy(np.stack([
        sliver_scene(S, seed=seed + i) for i in range(2)])).to(dev)
    scenes = {
        "banded": (fv_clip, "clip mesh"),
        "shuffled": (fv_shuf, "clip mesh, shuffled face order"),
        "slivers": (fv_sliver, "points, collinear faces and slivers"),
    }
    res = {k: compare_kernel(fv, S, what) for k, (fv, what) in scenes.items()}
    prep, prep_shuf = res["banded"]["prep"], res["shuffled"]["prep"]
    kernel_ms = cuda_time_ms(
        lambda: R.rasterize_prepared_cuda(prep, S, 0.1, 25.0), 20)
    kernel_shuf_ms = cuda_time_ms(
        lambda: R.rasterize_prepared_cuda(prep_shuf, S, 0.1, 25.0), 20)
    # with the depth output, and once more without, in turns
    depth_ms = cuda_time_ms(lambda: R.rasterize_prepared_cuda(
        prep, S, 0.1, 25.0, return_depth=True), 20)
    kernel_ms2 = cuda_time_ms(
        lambda: R.rasterize_prepared_cuda(prep, S, 0.1, 25.0), 20)
    depth_ms2 = cuda_time_ms(lambda: R.rasterize_prepared_cuda(
        prep, S, 0.1, 25.0, return_depth=True), 20)
    wrapper_ms = cuda_time_ms(lambda: R.rasterize_fim_wim(fv_clip, S), 20)
    plain_ms = cuda_time_ms(
        lambda: R.rasterize_prepared_reference(prep, S, 0.1, 25.0), 1)
    B, F = fv_clip.shape[:2]
    pairs = bbox_pairs(fv_clip, S)
    dense_pairs = B * S * S * F
    n_bytes = fv_clip.numel() * 4 + B * S * S * (4 + 12)
    ops_s = OPS_PER_PAIR * pairs / PEAK_FP32_FLOPS
    bytes_s = n_bytes / PEAK_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    depth_bytes_s = (n_bytes + B * S * S * 4) / PEAK_BYTES_PER_S
    depth_bound_ms = 1e3 * max(ops_s, depth_bytes_s)
    log(f"[kernel] clip: kernel {kernel_ms:.4f} ms (shuffled face order "
        f"{kernel_shuf_ms:.4f} ms), wrapper (prep+kernel) "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.2f} ms per 30-pose clip; "
        f"bbox pairs {pairs} of dense {dense_pairs} "
        f"({pairs / dense_pairs:.5f}); bound {bound_ms:.5f} ms "
        f"({'operations' if ops_s >= bytes_s else 'bytes'}) [{card}]")
    log(f"[kernel] clip with the depth output: {depth_ms:.4f} / "
        f"{depth_ms2:.4f} ms against {kernel_ms:.4f} / {kernel_ms2:.4f} ms "
        f"without (in turns: off, on, off, on); ratio "
        f"{(depth_ms + depth_ms2) / (kernel_ms + kernel_ms2):.3f}; bound "
        f"with depth {depth_bound_ms:.5f} ms [{card}]")
    for key, (fv, _) in scenes.items():
        st = survivor_stats(res[key]["prep"], res[key]["fim"], S)
        log(f"[kernel] {key}: faces tested per body tile mean "
            f"{st['mean']:.2f} max {st['max']}; pairs tested {st['pairs']} "
            f"against {bbox_pairs(fv, S)} bbox pairs")
    return {
        "max_abs_err": max(r["wim_max_abs"] for r in res.values()),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
        "fim_mismatch": max(r["fim_mismatch"] for r in res.values()),
        "ms_shuffled": kernel_shuf_ms,
        "depth_ms": depth_ms, "depth_bound_ms": depth_bound_ms,
        "depth_max_rel_err": max(r["depth_max_rel"] for r in res.values()),
        "depth_bitwise": all(r["depth_bitwise"] for r in res.values()),
    }


def check_outputs(out: dict, T: int, S: int, what: str) -> None:
    for k, c in (("final", 3), ("coarse", 3), ("mask", 1), ("tsf", 3)):
        if tuple(out[k].shape) != (T, S, S, c):
            raise AssertionError(f"{what}: {k} shape {tuple(out[k].shape)}")
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{what}: {k} has non-finite values")
    tsf = out["tsf"]
    if torch.all(tsf == tsf[:, :1, :1]):
        raise AssertionError(f"{what}: tsf is all fill; the mesh was missed")


def max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               for k in ("final", "coarse", "mask", "tsf"))


def phase_reference(seed: int) -> None:
    """The generator on the card against the same generator on the CPU
    (plain rasterizer there) on a small clip: same seeded weights."""
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
    from jafpro_tpu_torch.infer import VideoGenerator
    from jafpro_tpu_torch.pipeline import JAFProPipeline

    T, R, S, p = 6, 2, 64, 32
    clip, faces = make_clip(seed + 1, T, R, S, p, 24)
    cfg = Config(image_size=S, part_size=p, maximum_ref_frames=R,
                 compute_dtype="float32")
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = JAFProPipeline(
            cfg, flow_engine=SMPLFlowEngine(faces=faces, image_size=S),
            device=dev, generator=torch.Generator().manual_seed(seed))
        outs[dev] = VideoGenerator(pipe, frame_batch=3)(clip)
        check_outputs(outs[dev], T, S, f"reference clip on {dev}")
    d = max_diff(outs["cpu"], outs["cuda"])
    log(f"[reference] small clip S={S} T={T}: card vs CPU max abs {d:.3e}")
    if not d <= 1e-3:
        raise AssertionError("the card disagrees with the CPU reference")


def stage_breakdown(gen, clip: dict, card: str) -> None:
    """One more main-path clip with the generator's stage clock on (CUDA
    events around each stage inside ``VideoGenerator``)."""
    gen.time_stages = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen(clip)
    torch.cuda.synchronize()
    clip_ms = 1e3 * (time.perf_counter() - t0)
    gen.time_stages = False
    ms = gen.stage_ms
    total = sum(ms.values())
    log("[breakdown] " + "; ".join(
        f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
        for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))
        + f"; sum {total:.2f} ms of a {clip_ms:.2f} ms clip [{card}]")


def run_clip(gen, clip: dict, T: int, S: int, what: str, card: str) -> tuple:
    """One warm-up clip, checked, then the median of 3 timed clips."""
    out = gen(clip)
    torch.cuda.synchronize()
    check_outputs(out, T, S, what)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen(clip)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    clip_s = statistics.median(times)
    log(f"[slice] {what}: clip times {[round(t, 4) for t in times]} s; "
        f"warm {T / clip_s:.2f} frames/s (median of 3); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    return out, clip_s


def pack_clips(seed: int, n: int, T: int, NR: int, S: int, p: int, P: int,
               pack_dir: str) -> None:
    """``n`` seeded full-width clips packed by the writer behind ``pack
    --kind clips`` (``shardio.write_clip_pack``)."""
    from jafpro_tpu_torch.data.shardio import write_clip_pack

    write_clip_pack(
        (dict(make_clip(seed + 10 + i, T, NR, S, p, P)[0],
              vid_name=f"clip_{i}", chosen_names=[]) for i in range(n)),
        pack_dir, mode="test", num_refs=NR)


def rel_diff(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)


def u8_diff(a: dict, b: dict) -> int:
    """Largest difference of two clips' uint8 streams (tensors or arrays)."""
    def host(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        return x.astype(np.int16)

    return max(int(np.abs(host(a[k]) - host(b[k])).max())
               for k in ("final", "coarse", "mask", "tsf"))


def serve_pack(cfg, engine, seed: int, pack_dir: str, clips_per_batch: int,
               what: str, card: str) -> tuple:
    """The loop ``cli infer --packed-clips`` runs (``cli.serve`` over
    ``cli.open_clip_source``, ``cli.serving_generator``: uint8 on the
    card, several overlapping batches), with a writer that keeps the
    fetched frames (``cli.fetch_clips``) in memory instead of encoding
    jpgs. Served twice, first and warm; the rasterizer must launch once
    per batch in each."""
    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.geometry import rasterizer as R
    from jafpro_tpu_torch.ops import norm as N
    from jafpro_tpu_torch.pipeline import JAFProPipeline

    vids, load = cli.open_clip_source(cfg, cfg.maximum_ref_frames, pack_dir)
    pipe = JAFProPipeline(cfg, flow_engine=engine, device="cuda",
                          generator=torch.Generator().manual_seed(seed))
    gen = cli.serving_generator(pipe, cfg)
    groups = cli.group_items(vids, clips_per_batch)
    written = {}

    def write(group, out):
        written.update(cli.fetch_clips(group, out, cli.STREAMS))

    for run in ("first", "warm"):
        torch.cuda.reset_peak_memory_stats()
        R.rasterize_fim_wim.launches = 0
        N.sample_norm.launches = N.sample_norm.backward_launches = 0
        st = cli.serve(groups, load, cli.generate_group(gen), write)
        launches = R.rasterize_fim_wim.launches
        norms = (N.sample_norm.launches, N.sample_norm.backward_launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[serve] {what} {run} loop: {len(vids)} clips in {len(groups)} "
            f"batches of {clips_per_batch}: "
            f"{len(vids) / st['loop_seconds']:.3f} clips/s "
            f"({st['loop_seconds']:.4f} s); per batch load "
            f"{st['load_ms']:.2f} ms, compute {st['compute_ms']:.2f} ms, "
            f"write {st['write_ms']:.2f} ms; rasterize_fim_wim launches "
            f"{launches}; sample_norm kernel launches (forward, backward) "
            f"{norms}; peak memory {peak:.2f} GiB [{card}]")
        if launches != len(groups):
            raise AssertionError("a batch did not rasterize in one launch")
        if norms != (2 * 2 * NORM_CALLS * len(groups), 0):
            raise AssertionError("a batch's two CRNs did not take the norm "
                                 "kernels in every call")
    for vid in vids:
        for k, c in (("final", 3), ("coarse", 3), ("mask", 1), ("tsf", 3)):
            x = written[vid][k]
            if x.dtype != np.uint8 or x.shape != (
                    cfg.num_frames, cfg.image_size, cfg.image_size, c):
                raise AssertionError(f"served {vid}: {k} {x.dtype} {x.shape}")
    return vids, load, gen, written


def phase_serve(seed: int, engine, card: str) -> dict:
    """Phase 6: pack four clips, serve them in two batches through the
    CLI's loop (float32, then the CLI's default bfloat16), check the
    batches against per-clip generation, and score two of them. Returns
    each clip's frames generated alone in one process, by dtype ({dtype:
    {vid: {stream: uint8}}}; float32 through ``gen(clip)``, bfloat16 served
    alone, one clip per batch), for phase 11's ranks."""
    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.evaluate import evaluate_video
    from jafpro_tpu_torch.infer import VideoGenerator, stack_clips

    cfg = Config(compute_dtype="float32")
    T, NR, S, p, P = cfg.num_frames, cfg.maximum_ref_frames, \
        cfg.image_size, cfg.part_size, cfg.num_parts
    n_clips, per_batch = 4, 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as pack_dir:
        pack_clips(seed, n_clips, T, NR, S, p, P, pack_dir)
        mib = os.path.getsize(os.path.join(
            pack_dir, "test-clips-00000.shard")) / 2 ** 20
        log(f"[serve] packed {n_clips} clips ({mib:.1f} MiB) in "
            f"{time.perf_counter() - t0:.2f} s")
        vids, load, gen, served = serve_pack(
            cfg, engine, seed, pack_dir, per_batch, "float32", card)
        clips = load(vids)
        # each served clip against the same generator on that clip alone
        # (kept: phase 11's ranks are held to it)
        alone = {vid: {k: v.cpu().numpy() for k, v in gen(clip).items()}
                 for vid, clip in zip(vids, clips)}
        d = max(u8_diff(served[vid], alone[vid]) for vid in vids)
        log(f"[serve] served (uint8) vs per-clip generation: max {d} LSB")
        if not d <= 1:
            raise AssertionError("a served batch disagrees with per-clip "
                                 "generation")
        # the batch in float32 against per-clip generation in float32
        fgen = VideoGenerator(gen.pipe, frame_batch=T, flow_mode="batch")
        batch = fgen.generate_batch(stack_clips(clips[:per_batch]))
        d = 0.0
        for ci, clip in enumerate(clips[:per_batch]):
            single = fgen(clip)
            check_outputs(single, T, S, f"clip {vids[ci]}")
            d = max(d, max_diff({k: v[ci] for k, v in batch.items()},
                                single))
        log(f"[serve] float32 batch vs per-clip generation: max abs {d:.3e}")
        if not d <= 1e-4:
            raise AssertionError("the batch disagrees with per-clip "
                                 "generation")
        del gen, fgen, batch
        # the dtype `cli infer` serves in (Config's default)
        _, load16, gen16, served16 = serve_pack(
            Config(), engine, seed, pack_dir, per_batch, "bfloat16", card)
        log(f"[serve] bfloat16 vs float32 served: max "
            f"{max(u8_diff(served16[v], served[v]) for v in vids)} LSB")
        # each clip served alone (one per batch) in one process, which
        # phase 11's ranks are held to; beside it the same clip through
        # gen16(clip), whose inputs carry other strides on their size-1
        # axes: in bfloat16 that alone moves a frame by several steps
        one = cli.generate_group(gen16)
        clips16 = load16(vids)
        alone16 = {vid: {k: v[0].cpu().numpy()
                         for k, v in one((vid,), [c]).items()}
                   for vid, c in zip(vids, clips16)}
        called = {vid: gen16(c) for vid, c in zip(vids, clips16)}
        log(f"[serve] bfloat16 each clip served alone vs served {per_batch} "
            f"per batch: max "
            f"{max(u8_diff(alone16[v], served16[v]) for v in vids)} LSB; vs "
            f"gen(clip): max "
            f"{max(u8_diff(alone16[v], called[v]) for v in vids)} LSB")
        del gen16, served16, called

    # score with the TF32 settings `cli evaluate` runs under (PyTorch's
    # defaults); evaluate_video turns TF32 off itself
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = TF32_DEFAULTS
    nets = {dev: cli._metric_hooks(dev) for dev in ("cuda", "cpu")}
    for vid in vids[:per_batch]:
        pred, gt = served[vid]["final"], served[vid]["coarse"]
        card_m = evaluate_video(pred, gt, device="cuda", **nets["cuda"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        evaluate_video(pred, gt, device="cuda", **nets["cuda"])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        cpu_m = evaluate_video(pred, gt, device="cpu", **nets["cpu"])
        cpu_s = time.perf_counter() - t1
        r = rel_diff(card_m, cpu_m)
        log(f"[score] {vid} final vs coarse: "
            + ", ".join(f"{k} {v:.6g}" for k, v in card_m.items())
            + f"; evaluate {card_s:.4f} s per clip on the card ({cpu_s:.2f} "
            f"s on the CPU); card vs CPU max rel {r:.3e}; TF32 flags "
            f"cudnn={torch.backends.cudnn.allow_tf32} "
            f"matmul={torch.backends.cuda.matmul.allow_tf32} [{card}]")
        if set(card_m) != {"ssim", "l1", "ms_ssim", "psnr", "vgg",
                           "flow_l1"} or not all(
                np.isfinite(v) for v in card_m.values()):
            raise AssertionError(f"bad metrics for {vid}: {card_m}")
        if not r <= 1e-3:
            raise AssertionError("the card's metrics disagree with the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[serve] phase 6 took {time.perf_counter() - t0:.1f} s")
    return {"float32": alone, "bfloat16": alone16}


def pack_train_records(cfg, seed: int, stage: int, n: int, clip_verts,
                       clip_cams, path: str) -> None:
    """``n`` seeded records of ``stage``'s layout (``shardio.stage_spec``)
    at ``cfg``'s widths packed into ``path``: uniform uint8 textures,
    half-visible masks; interval records take their poses from the clip
    mesh and an IUV map confined to the body's columns (``make_clip``)."""
    from jafpro_tpu_torch.data.dataset import face_bbox_from_iuv
    from jafpro_tpu_torch.data.shardio import (
        encode_field_u8, pack_shard, stage_spec)

    NR, S, P = cfg.maximum_ref_frames, cfg.image_size, cfg.num_parts
    spec = stage_spec(stage, num_refs=NR, num_target=cfg.num_target,
                      image_size=S, part_size=cfg.part_size, num_parts=P,
                      num_verts=clip_verts.shape[1])
    rng = np.random.RandomState(seed)

    def records():
        for i in range(n):
            rec = {}
            for name, shape, dtype in spec:
                if name.endswith("mask_parts"):
                    rec[name] = (rng.rand(*shape) > 0.5).astype(np.uint8) * 255
                elif dtype == "uint8":
                    rec[name] = rng.randint(0, 256, shape).astype(np.uint8)
            if stage <= 2:
                yield rec
                continue
            clip, _ = make_clip(seed + i, NR + 1, NR, S, 2, P)
            t = rng.choice(clip_verts.shape[0], NR + 1, replace=False)
            iuv = clip["tgt_iuv255"][0]
            rec["tgt_iuv255"] = iuv[None].astype(np.uint8)
            rec["smpl_mask"] = encode_field_u8(
                "smpl_mask", (iuv[..., :1] > 0).astype(np.float32))[None]
            rec["bg_incomplete"] = clip["bg_incomplete"]
            rec["face_bbox"] = face_bbox_from_iuv(iuv)[None]
            rec["src_cams"], rec["tgt_cam"] = clip_cams[t[1:]], clip_cams[t[:1]]
            rec["src_verts"] = clip_verts[t[1:]]
            rec["tgt_verts"] = clip_verts[t[:1]]
            yield rec

    pack_shard(spec, records(), path)


def snapshot(pipe) -> dict:
    from jafpro_tpu_torch.bridge import ALL_MODULES

    return {n: [q.detach().clone() for q in getattr(pipe, n).parameters()]
            for n in ALL_MODULES}


def moved_modules(before: dict, pipe) -> tuple:
    """(modules with a changed param, modules bitwise unchanged)."""
    moved, same = set(), set()
    for n, ps in before.items():
        eq = [torch.equal(a, b) for a, b in zip(ps, getattr(pipe, n)
                                                 .parameters())]
        (same if all(eq) else moved).add(n)
    return moved, same


def count_poses(engine) -> list:
    """Record the poses of each ``render_fim_wim`` call of ``engine`` (one
    rasterizer launch each) into the returned list; ``del
    engine.render_fim_wim`` undoes it."""
    poses: list = []
    render = engine.render_fim_wim

    def counted(cam, v):
        poses.append(cam.shape[0])
        return render(cam, v)

    engine.render_fim_wim = counted
    return poses


def train_stage(cfg, stage: int, shard_dir: str, engine, verts, seed: int,
                card: str) -> dict:
    """One stage as ``cli train --shards`` runs it: 1 warm-up and 3 timed
    steps at ``cfg``'s widths, the CLI's batch. ``verts`` (V, 3) gives the
    records' vertex count. Returns its numbers."""
    import argparse as _argparse

    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.geometry import rasterizer as R
    from jafpro_tpu_torch.ops import norm as N
    from jafpro_tpu_torch.pipeline import JAFProPipeline
    from jafpro_tpu_torch.train.common import (
        TrainState, apply_curriculum, to_device)

    cfg = dataclasses.replace(cfg, batch_size=2 if stage == 2 else 4)
    dtype = cfg.compute_dtype
    pipe = JAFProPipeline(cfg, flow_engine=engine, device="cuda",
                          generator=torch.Generator().manual_seed(seed))
    step, lrs = cli.make_step(pipe, stage)
    state = TrainState(pipe, lrs)
    args = _argparse.Namespace(shards=shard_dir, stage=stage, seed=seed,
                               synthetic=False)
    rng = np.random.RandomState(seed)
    next_raw, close = cli._raw_batch_source(args, cfg, rng, verts)
    before = snapshot(pipe)
    poses = count_poses(engine)
    torch.cuda.reset_peak_memory_stats()
    times, launches, losses, norms = [], [], [], []
    try:
        for _ in range(4):
            batch = to_device(apply_curriculum(dict(next_raw()), stage, rng,
                                               cfg.maximum_ref_frames),
                              torch.device("cuda"))
            torch.cuda.synchronize()
            R.rasterize_fim_wim.launches = 0
            N.sample_norm.launches = N.sample_norm.backward_launches = 0
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(R.rasterize_fim_wim.launches)
            norms.append((N.sample_norm.launches,
                          N.sample_norm.backward_launches))
            losses.append({k: float(v) for k, v in m.items()})
    finally:
        close()
        del engine.render_fim_wim
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved, same = moved_modules(before, pipe)
    s_step = statistics.median(times[1:])
    log(f"[train] stage {stage} {dtype}: batch {cfg.batch_size}; step times "
        f"{[round(t, 4) for t in times]} s (first is warm-up); "
        f"{s_step:.4f} s/step, {cfg.batch_size / s_step:.3f} samples/s "
        f"(median of 3); peak memory {peak:.2f} GiB; rasterize_fim_wim "
        f"launches per step {launches}, poses per launch {poses}; "
        f"sample_norm kernel launches per step (forward, backward) "
        f"{norms}; moved {sorted(moved)}; unchanged {sorted(same)} [{card}]")
    log(f"[train] stage {stage} {dtype} losses: " + "; ".join(
        ", ".join(f"{k} {v:.5g}" for k, v in m.items()) for m in losses))
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"stage {stage}: a loss is not finite")
    if moved != set(lrs):
        raise AssertionError(f"stage {stage}: moved {moved}, trains "
                             f"{set(lrs)}")
    if stage == 4:
        if "bg" not in same:
            raise AssertionError("stage 4 changed the frozen bg")
        if launches != [1] * 4 or poses != [cfg.batch_size] * 4:
            raise AssertionError("a stage-4 step did not rasterize the "
                                 "batch's poses in one kernel launch")
        if len(set(norms)) != 1 or not norms[0][1]:
            raise AssertionError("the stage-4 steps' norm kernel launches "
                                 f"{norms} differ or hold no backward")
    elif any(launches):
        raise AssertionError(f"stage {stage} rasterized")
    return {"s_step": s_step, "peak": peak, "launches": sum(launches),
            "norms": norms[-1]}


def sgd_setup(dev, seed: int, batch: int, ragged: bool = False) -> tuple:
    """(pipeline, batch (numpy)) of the 64 px SGD steps: parts of 16, 2
    refs, float32 on ``dev``, seeded weights and a seeded batch on the 6x6
    quad mesh. ``ragged`` empties the last sample's face box, so that on 2
    ranks the first holds two faces and the second one."""
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
    from jafpro_tpu_torch.pipeline import JAFProPipeline
    from jafpro_tpu_torch.train.common import (
        synthetic_batch, synthetic_quad_mesh)

    verts, faces = synthetic_quad_mesh(6)
    cfg = Config(image_size=64, part_size=16, maximum_ref_frames=2,
                 face_crop_size=16, compute_dtype="float32")
    pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
        faces=faces, image_size=64), device=dev,
        generator=torch.Generator().manual_seed(seed))
    b = synthetic_batch(np.random.RandomState(seed), batch=batch,
                        num_refs=2, part_size=16, image_size=64,
                        num_verts=verts.shape[0], num_targets=2)
    b["prev_verts"] = np.tile(verts[None], (batch, 1, 1))
    b["tgt_verts"] = b["prev_verts"] + np.float32([0.05, 0.0, 0.0])
    if ragged:
        b["face_bbox"][-1, 1] = b["face_bbox"][-1, 0]
    return pipe, b


def sgd_step_on(dev: str, stage: int, seed: int, batch: int) -> tuple:
    """One SGD (lr 1e-3) step of ``stage`` of ``sgd_setup`` on ``dev``:
    (before, after (JAX trees), metrics)."""
    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.bridge import jax_params
    from jafpro_tpu_torch.train.common import TrainState, to_device

    pipe, b = sgd_setup(dev, seed, batch)
    before = jax_params(pipe)
    step, lrs = cli.make_step(pipe, stage)
    state = TrainState(pipe, lrs,
                       optimizer=lambda ps, lr: torch.optim.SGD(ps, 1e-3))
    state, m = step(state, to_device(b, torch.device(dev)))
    return before, jax_params(pipe), {k: float(v) for k, v in m.items()}


# Card vs CPU, one SGD step: every metric within TRAIN_METRIC_RTOL
# relative; each module's update (after - before, all its params) within
# TRAIN_UPDATE_RTOL of its L2 norm. Measured on an H100 at these batches:
# 2.4e-7 and 9.9e-4 (cuDNN's float32 algorithms sum in another order than
# the CPU; the texture warp's backward scatters with atomics). Stage 4
# runs at batch 4: at batch 2 the 64 px image D normalizes 2 values per
# channel on its 1x1 map and the step is ill-conditioned (a 1e-5 change
# of the input moves the generator's updates by 2-3% on the CPU alone,
# tools/train_conditioning.py).
TRAIN_METRIC_RTOL = 1e-5
TRAIN_UPDATE_RTOL = 5e-3
TRAIN_REF_BATCH = {1: 2, 4: 4}


def phase_train_reference(seed: int, stages=(1, 4)) -> None:
    """One SGD step of each of ``stages`` on the card and on the CPU from
    the same seeded weights; raises unless they agree within
    ``TRAIN_METRIC_RTOL`` / ``TRAIN_UPDATE_RTOL``."""
    from jafpro_tpu_torch.checkpoints import flatten

    for stage in stages:
        B = TRAIN_REF_BATCH[stage]
        b_gpu, a_gpu, m_gpu = sgd_step_on("cuda", stage, seed, B)
        b_cpu, a_cpu, m_cpu = sgd_step_on("cpu", stage, seed, B)
        worst_m = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                      for k in m_cpu)
        b0, ag, ac = (flatten(t) for t in (b_cpu, a_gpu, a_cpu))
        err: dict = {}
        for name, p0 in b0.items():
            du, dc = ag[name] - p0, ac[name] - p0
            e = err.setdefault(name.split("/")[0], [0.0, 0.0])
            e[0] += float(np.square(du - dc, dtype=np.float64).sum())
            e[1] += float(np.square(dc, dtype=np.float64).sum())
        moved_cpu = {k for k, (_, n) in err.items() if n > 0}
        if {k for k, (d, n) in err.items() if n == 0 and d > 0}:
            raise AssertionError(f"stage {stage}: a module moved on the "
                                 "card only")
        rel = {k: (d / n) ** 0.5 for k, (d, n) in err.items()
               if k in moved_cpu}
        log(f"[train] card vs CPU, one SGD step of stage {stage} (64 px, "
            f"batch {B}, float32, TF32 off): metrics max rel {worst_m:.3e} "
            f"(tolerance {TRAIN_METRIC_RTOL}); update rel L2 per module "
            + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rel.items()))
            + f" (tolerance {TRAIN_UPDATE_RTOL})")
        if not (worst_m <= TRAIN_METRIC_RTOL
                and max(rel.values()) <= TRAIN_UPDATE_RTOL):
            raise AssertionError(f"stage {stage}: the card's step disagrees "
                                 "with the CPU's")


def phase_train(seed: int, clip: dict, engine, card: str) -> tuple:
    """Phase 7 at ``Config()`` widths. Returns the rasterizer launches of
    the stage-4 runs and the norm kernels' (forward, backward) launches of
    one bfloat16 stage-4 step."""
    from jafpro_tpu_torch.config import Config

    cfg = Config()
    t0 = time.perf_counter()
    verts, cams = clip["verts"], clip["cams"]
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for kind, stages in (("textonly", (1, 2)), ("interval", (3, 4))):
            d = os.path.join(root, kind)
            os.makedirs(d)
            t1 = time.perf_counter()
            pack_train_records(cfg, seed + 20, stages[0], 8, verts, cams,
                               os.path.join(d, f"train-{kind}-00000.shard"))
            mib = os.path.getsize(os.path.join(
                d, f"train-{kind}-00000.shard")) / 2 ** 20
            log(f"[train] packed 8 {kind} records ({mib:.1f} MiB) in "
                f"{time.perf_counter() - t1:.2f} s")
            for stage in stages:
                out[(stage, "bfloat16")] = train_stage(
                    bf16, stage, d, engine, verts[0], seed, card)
        log(f"[train] float32: cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}")
        out[(4, "float32")] = train_stage(
            dataclasses.replace(cfg, compute_dtype="float32"), 4,
            os.path.join(root, "interval"), engine, verts[0], seed, card)
    phase_train_reference(seed)
    log(f"[train] phase 7 took {time.perf_counter() - t0:.1f} s")
    return (sum(v["launches"] for k, v in out.items() if k[0] == 4),
            out[(4, "bfloat16")]["norms"])


def median_ms(fn, n: int = 3) -> tuple:
    """One warm-up call of ``fn``, then ``n`` timed calls, each ending in a
    synchronize: (median ms, the times)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), times


def body_inputs(seed: int, n: int, S: int, hmr_size: int) -> dict:
    """Seeded inputs of the body path: ``n`` images for HMR, moderate
    poses (|theta| <= 0.3) and shapes, cameras, images to texture from and
    a cotangent for the silhouettes."""
    rng = np.random.RandomState(seed + 30)
    f32 = np.float32
    return {
        "hmr_imgs": rng.uniform(-1, 1, (n, 3, hmr_size, hmr_size)).astype(f32),
        "beta": (0.5 * rng.randn(n, 10)).astype(f32),
        "theta": rng.uniform(-0.3, 0.3, (n, 72)).astype(f32),
        "cam": np.concatenate([rng.uniform(0.85, 0.95, (n, 1)),
                               rng.uniform(-0.05, 0.05, (n, 2))], 1
                              ).astype(f32),
        "imgs": rng.uniform(-1, 1, (n, 3, S, S)).astype(f32),
        "weight": rng.uniform(0.5, 1.5, (n, S, S)).astype(f32),
    }


def body_models(seed: int, dev: str, S: int):
    """HMR (float32), SMPL on the phase-3 sphere (SMPL's sizes) and the
    renderer with some directional light, all from seeds, on ``dev``."""
    from jafpro_tpu_torch.geometry.renderer import SMPLRenderer
    from jafpro_tpu_torch.geometry.smpl import SMPLModel
    from jafpro_tpu_torch.models.hmr import HumanModelRecovery
    from jafpro_tpu_torch.utils.meshproxy import uv_sphere

    verts, faces = uv_sphere()
    template = verts * np.float32([0.35, 0.9, 0.35])
    hmr = HumanModelRecovery(device=dev,
                             generator=torch.Generator().manual_seed(seed))
    smpl = SMPLModel.synthetic(seed=seed, v_template=template, faces=faces,
                               device=dev)
    rend = SMPLRenderer(faces=faces, image_size=S, tex_size=3, device=dev,
                        light_intensity_ambient=0.7,
                        light_intensity_directional=0.5,
                        light_direction=(0.0, 0.6, -0.8))
    return hmr, smpl, rend


def body_pass(hmr, smpl, rend, x: dict) -> dict:
    """The body path once: HMR's theta and get_details, SMPL on the given
    poses, then render_depth, extract_tex_from_image, render with lighting
    and render_silhouettes(edge_gradients=True) with a backward to the
    vertices and camera."""
    from jafpro_tpu_torch.models.hmr import get_details

    with torch.no_grad():
        theta = hmr(x["hmr_imgs"])
        details = get_details(smpl, theta)
        verts = smpl(x["beta"], x["theta"])[0]
        depth = rend.render_depth(x["cam"], verts)
        tex = rend.extract_tex_from_image(x["imgs"], x["cam"], verts)
        img = rend.render(x["cam"], verts, tex)
    v = verts.clone().requires_grad_()
    c = x["cam"].clone().requires_grad_()
    sil = rend.render_silhouettes(c, v, edge_gradients=True)
    (sil * x["weight"]).sum().backward()
    return {"theta": theta, "details": details, "verts": verts,
            "depth": depth, "tex": tex, "img": img, "sil": sil.detach(),
            "g_verts": v.grad, "g_cam": c.grad}


def check_body(out: dict, n: int, S: int, V: int) -> None:
    """Shapes as the JAX package gives them (images NCHW in the port),
    every value finite, depth 0 exactly off the body."""
    want = {"theta": (n, 85), "cam": (n, 3), "pose": (n, 72),
            "shape": (n, 10), "verts": (n, V, 3), "j2d": (n, 19, 2),
            "j3d": (n, 19, 3)}
    for k, shape in want.items():
        t = out["details"][k]
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"get_details {k}: {tuple(t.shape)}")
    for k, shape in (("verts", (n, V, 3)), ("depth", (n, S, S)),
                     ("img", (n, 3, S, S)), ("sil", (n, S, S)),
                     ("g_verts", (n, V, 3)), ("g_cam", (n, 3))):
        t = out[k]
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"body {k}: {tuple(t.shape)} or not finite")
    body = out["sil"] > 0
    if not (0.02 < float(body.float().mean()) < 0.9):
        raise AssertionError("the posed meshes do not cover the image")
    if (out["depth"][~body] != 0).any() or (out["depth"][body] <= 0).any():
        raise AssertionError("depth is not 0 exactly off the body")
    if not out["g_verts"].abs().max() > 0:
        raise AssertionError("the silhouettes' edge gradient is zero")


def on_dev(x: dict, dev: str) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}


def phase_body(seed: int, card: str) -> int:
    """Phase 8: the body path at full width on the card, then a small
    version against the CPU. Returns the rasterizer launches of one pass
    of the path."""
    from jafpro_tpu_torch.geometry import rasterizer as R
    from jafpro_tpu_torch.models.hmr import HumanModelRecovery

    t_phase = time.perf_counter()
    n, S, V = 30, 256, 6890
    torch.cuda.reset_peak_memory_stats()
    hmr, smpl, rend = body_models(seed, "cuda", S)
    x = on_dev(body_inputs(seed, n, S, 224), "cuda")
    R.rasterize_fim_wim.launches = 0
    out = body_pass(hmr, smpl, rend, x)
    torch.cuda.synchronize()
    launches = R.rasterize_fim_wim.launches
    check_body(out, n, S, V)
    log(f"[body] one pass (HMR, get_details, SMPL, render_depth, "
        f"extract_tex_from_image, render, silhouettes + backward): "
        f"rasterize_fim_wim launches {launches} [{card}]")
    if launches != 3:
        raise AssertionError("the body path did not rasterize once per "
                             "render_depth, render and silhouettes")

    # times, median of 3 after one warm-up
    verts, tex = out["verts"], out["tex"]
    hmr16 = HumanModelRecovery(compute_dtype=torch.bfloat16, device="cuda",
                               generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        theta16 = hmr16(x["hmr_imgs"])
    d16 = float((theta16 - out["theta"]).abs().max() /
                out["theta"].abs().max())

    def sil_backward():
        v = verts.clone().requires_grad_()
        c = x["cam"].clone().requires_grad_()
        (rend.render_silhouettes(c, v, edge_gradients=True)
         * x["weight"]).sum().backward()

    steps = {}
    with torch.no_grad():
        steps["hmr float32"] = median_ms(lambda: hmr(x["hmr_imgs"]))
        steps["hmr bfloat16"] = median_ms(lambda: hmr16(x["hmr_imgs"]))
        steps["smpl"] = median_ms(lambda: smpl(x["beta"], x["theta"]))
        steps["render_depth"] = median_ms(
            lambda: rend.render_depth(x["cam"], verts))
        steps["extract_tex_from_image"] = median_ms(
            lambda: rend.extract_tex_from_image(x["imgs"], x["cam"], verts))
        steps["render (lighting)"] = median_ms(
            lambda: rend.render(x["cam"], verts, tex))
    steps["silhouettes edge + backward"] = median_ms(sil_backward)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k, (ms, times) in steps.items():
        log(f"[body] {k}: {ms:.3f} ms per {n} (median of 3: "
            f"{[round(t, 3) for t in times]}) [{card}]")
    log(f"[body] HMR 224x224 blocks {hmr.resnet.num_blocks}, float32 TF32 "
        f"off (cudnn={torch.backends.cudnn.allow_tf32} matmul="
        f"{torch.backends.cuda.matmul.allow_tf32}); bfloat16 theta max rel "
        f"{d16:.3e} from float32; SMPL V={V}; renderer {S}x{S} T=3 "
        f"F={rend.faces.shape[0]}; peak memory {peak:.2f} GiB [{card}]")
    del hmr, hmr16, out, tex

    # card vs CPU at 64x64, 2 poses, float32, TF32 off, the same seeds
    ns, Ss = 2, 64
    xs = body_inputs(seed + 1, ns, Ss, Ss)
    res = {}
    for dev in ("cpu", "cuda"):
        hmr_d, smpl_d, rend_d = body_models(seed, dev, Ss)
        xd = on_dev(xs, dev)
        with torch.no_grad():
            theta = hmr_d(xd["hmr_imgs"])
            verts = smpl_d(xd["beta"], xd["theta"])[0]
        # the renderer gets the CPU's vertices on both, so that its face
        # ids are the same on both (the kernel equals its plain version)
        v0 = res["cpu"]["verts"].to(dev) if dev == "cuda" else verts
        tex = rend_d.extract_tex_from_image(xd["imgs"], xd["cam"], v0)
        v = v0.clone().requires_grad_()
        img = rend_d.render(xd["cam"], v, tex, edge_gradients=True)
        (img * xd["imgs"]).sum().backward()
        vs = v0.clone().requires_grad_()
        (rend_d.render_silhouettes(xd["cam"], vs, edge_gradients=True)
         * xd["weight"]).sum().backward()
        res[dev] = {k: t.detach().cpu() for k, t in (
            ("theta", theta), ("verts", verts), ("img", img),
            ("g_render", v.grad), ("g_sil", vs.grad))}
    a, b = res["cuda"], res["cpu"]
    theta_rel = float((a["theta"] - b["theta"]).abs().max()
                      / b["theta"].abs().max())
    verts_abs = float((a["verts"] - b["verts"]).abs().max())
    img_abs = float((a["img"] - b["img"]).abs().max())
    for k in ("g_render", "g_sil"):
        if not (torch.isfinite(b[k]).all() and b[k].norm() > 0):
            raise AssertionError(f"the CPU's {k} is zero or not finite")
    g_rel = {k: float((a[k] - b[k]).norm() / b[k].norm())
             for k in ("g_render", "g_sil")}
    log(f"[body] card vs CPU ({Ss}x{Ss}, {ns} poses, float32, TF32 off): "
        f"HMR theta max rel {theta_rel:.3e} (tolerance 1e-4), SMPL verts "
        f"max abs {verts_abs:.3e} (1e-5), rendered image max abs "
        f"{img_abs:.3e} (1e-4), vertex gradient rel L2 render "
        f"{g_rel['g_render']:.3e} silhouettes {g_rel['g_sil']:.3e} (1e-3) "
        f"[{card}]")
    if not (theta_rel <= 1e-4 and verts_abs <= 1e-5 and img_abs <= 1e-4
            and all(v <= 1e-3 for v in g_rel.values())):
        raise AssertionError("the body path on the card disagrees with the "
                             "CPU")
    log(f"[body] phase 8 took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return launches


# ---------------------------------------------------------------- phase 9

# the correlation kernel's scenes: (name, (B, C, H, W), md, s2)
CORR_SCENES = (
    ("flownetc_256", (8, 256, 32, 32), 20, 2),   # FlowNetC at 256² crops
    ("sintel_384x1024", (2, 256, 48, 128), 20, 2),
    ("odd", (1, 256, 13, 29), 20, 2),
    ("md4_s1", (2, 256, 32, 32), 4, 1),
    ("ragged", (3, 72, 20, 70), 8, 2),   # C, W ragged against the tiles
    ("wide_c", (2, 2085, 12, 40), 20, 2),   # f1's row streamed
)
FLOWNET2_CORR_SHAPE = (29, 256, 32, 32)   # FlowNet2 on a 30-frame clip
CORR_FWD_ATOL = 1e-5      # float32 forward, unit-normal inputs
CORR_BWD_RTOL = 1e-5      # float32 backward, relative L2 per gradient
FLOW_BATCH, FLOW_SIZE = 8, 256   # the reference harness's defaults
# FlowNetC card vs CPU (64², batch FLOW_REF_BATCH, float32, TF32 off): the
# forward within FLOW_FWD_RTOL of the largest output; one SGD harness step
# within FLOW_METRIC_RTOL on loss and EPE and FLOW_UPDATE_RTOL on each
# module's update (relative L2), PR 8's convention. Batch 4: at 64² conv6
# is 1x1, and at batch 2 its training-mode batch norm normalises 2 values
# per channel, whose gradient (1 - x̂²)/σ is a difference of nearly equal
# numbers; measured on an H100, the step's updates then differ from the
# CPU's by 0.81 (conv2a), while the same step with batch norm on running
# statistics agrees within 6.5e-4, and at batch 4 within 2.2e-3.
FLOW_FWD_RTOL = 1e-4
FLOW_METRIC_RTOL = 1e-5
FLOW_UPDATE_RTOL = 5e-3
FLOW_REF_BATCH = 4


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def corr_bound_ms(shape, md: int, s2: int, itemsize: int,
                  backward: bool) -> tuple:
    """(least ms, "bytes" or "operations") of the forward or the backward
    on the card: float32 multiply-adds on the CUDA cores against each
    input read once and each output written once (B4's operations and
    bytes as the benchmark counts them, ``benchmark/flow_counts.py``)."""
    from benchmark import flow_counts

    ops = flow_counts.b4_flops(shape, md, s2, backward)
    nbytes = flow_counts.b4_bytes(shape, md, s2, itemsize, backward)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def corr_tc_bound_ms(shape, md: int, s2: int, backward: bool) -> float:
    """The 3xTF32 tensor-core bound: three TF32 products per float32
    multiply-add of the function at the dense TF32 rate (the kernel's
    banded tiles compute more; not the reported bound)."""
    from benchmark import flow_counts

    return 1e3 * 3 * flow_counts.b4_flops(shape, md, s2,
                                          backward) / PEAK_TF32_FLOPS


def corr_reported_bound(shape, md: int, s2: int, backward: bool) -> tuple:
    """(bound ms, "bytes" or "operations", the rate it is taken at) that
    the kernels line reports for B4 in float32: the larger of the bytes
    time and the lower of the two operation times, FP32 on the CUDA cores
    (``corr_bound_ms``) and 3xTF32 on the tensor cores
    (``corr_tc_bound_ms``, the kernel's own arithmetic)."""
    from benchmark import flow_counts

    t_bytes = 1e3 * flow_counts.b4_bytes(shape, md, s2, 4,
                                         backward) / PEAK_BYTES_PER_S
    ops = {"FP32 CUDA cores": 1e3 * flow_counts.b4_flops(
        shape, md, s2, backward) / PEAK_FP32_FLOPS,
           "3xTF32 tensor cores": corr_tc_bound_ms(shape, md, s2, backward)}
    rate = min(ops, key=ops.get)
    if t_bytes >= ops[rate]:
        return t_bytes, "bytes", "HBM"
    return ops[rate], "operations", rate


def median_cuda_ms(fn, reps: int = 5, iters: int = 3) -> float:
    return statistics.median(cuda_time_ms(fn, iters) for _ in range(reps))


def check_corr_scene(name: str, shape, md: int, s2: int, gen) -> dict:
    """Forward and backward kernels against the plain version on one
    scene, float32 and bfloat16; raises on a mismatch."""
    # the module: ``jafpro_tpu_torch.ops.correlation`` names the function,
    # as the JAX package's ``ops`` does
    OC = importlib.import_module("jafpro_tpu_torch.ops.correlation")

    dev = torch.device("cuda")
    for dt in (torch.float32, torch.bfloat16):
        want = OC.launch_plan(shape, md, s2, dt)
        got = OC.kernel_plan(shape, md, s2, dt)
        if any(got[k] != {f: want[k][f] for f in got[k]}
               for k in ("forward", "backward")):
            raise AssertionError(f"{name}: the source's launch plan {got} "
                                 f"is not launch_plan's {want}")
    f1 = torch.randn(shape, generator=gen).to(dev)
    f2 = torch.randn(shape, generator=gen).to(dev)
    out = {}
    ref = OC.correlation_reference(f1, f2, md, s2)
    g = torch.randn(ref.shape, generator=gen).to(dev)
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    ref_g = torch.autograd.grad(OC.correlation_reference(a, b, md, s2),
                                (a, b), g)
    for dt in (torch.float32, torch.bfloat16):
        x1, x2 = f1.to(dt), f2.to(dt)
        ker = OC.correlation_cuda(x1, x2, md, s2)
        k1, k2 = OC.correlation_backward_cuda(g.to(dt), x1, x2, md, s2)
        # through the autograd Function, as the nets call it
        a, b = x1.clone().requires_grad_(), x2.clone().requires_grad_()
        fn_g = torch.autograd.grad(OC.correlation(a, b, md, s2), (a, b),
                                   g.to(dt))
        torch.cuda.synchronize()
        if not (torch.equal(fn_g[0], k1) and torch.equal(fn_g[1], k2)):
            raise AssertionError(f"{name}: the autograd Function's gradient "
                                 "is not the backward kernel's")
        if dt == torch.float32:
            fwd = float((ker - ref).abs().max())
            bwd = max(rel_l2(k1, ref_g[0]), rel_l2(k2, ref_g[1]))
            bwd_abs = max(float((k1 - ref_g[0]).abs().max()),
                          float((k2 - ref_g[1]).abs().max()))
            log(f"[corr] {name} {tuple(shape)} md {md} s2 {s2} float32: "
                f"forward max abs {fwd:.3e} (tolerance {CORR_FWD_ATOL}), "
                f"backward rel L2 {bwd:.3e} (tolerance {CORR_BWD_RTOL}), "
                f"max abs {bwd_abs:.3e}")
            if not (fwd <= CORR_FWD_ATOL and bwd <= CORR_BWD_RTOL):
                raise AssertionError(f"{name}: the float32 kernels disagree "
                                     "with the plain version")
            out["max_abs_err"], out["bwd_max_abs_err"] = fwd, bwd_abs
            continue
        # bfloat16: against float32 on the same rounded inputs, the kernel
        # within twice the plain bf16 form's own error
        r32 = OC.correlation_reference(x1.float(), x2.float(), md, s2)
        a, b = x1.float().requires_grad_(), x2.float().requires_grad_()
        r32_g = torch.autograd.grad(OC.correlation_reference(a, b, md, s2),
                                    (a, b), g.to(dt).float())
        a, b = x1.clone().requires_grad_(), x2.clone().requires_grad_()
        plain = OC.correlation_reference(a, b, md, s2)
        p_g = torch.autograd.grad(plain, (a, b), g.to(dt))
        fk = float((ker.float() - r32).abs().max())
        fp = float((plain.detach().float() - r32).abs().max())
        bk = max(rel_l2(k1.float(), r32_g[0]), rel_l2(k2.float(), r32_g[1]))
        bp = max(rel_l2(p_g[0].float(), r32_g[0]),
                 rel_l2(p_g[1].float(), r32_g[1]))
        log(f"[corr] {name} bfloat16 vs float32: forward kernel {fk:.3e}, "
            f"plain {fp:.3e}; backward rel L2 kernel {bk:.3e}, plain "
            f"{bp:.3e} (tolerance: twice the plain form's)")
        if not (fk <= 2 * fp and bk <= 2 * bp):
            raise AssertionError(f"{name}: the bfloat16 kernels are further "
                                 "from float32 than twice the plain form")
        out["bf16_err"] = fk
    return out


CORR_ITERS = 20   # launches per timed run of a kernel


def time_corr(shape, md: int, s2: int, gen, card: str) -> dict:
    """Median ms of the kernels and the plain form at ``shape`` (float32),
    forward and forward + backward, beside the bound and its share; the
    forward at FlowNet2's clip shape; and what a channels-last copy of
    both inputs would cost."""
    # the module: ``jafpro_tpu_torch.ops.correlation`` names the function,
    # as the JAX package's ``ops`` does
    OC = importlib.import_module("jafpro_tpu_torch.ops.correlation")

    dev = torch.device("cuda")
    c1 = torch.randn(FLOWNET2_CORR_SHAPE, generator=gen).to(dev)
    c2 = torch.randn(FLOWNET2_CORR_SHAPE, generator=gen).to(dev)
    f1 = torch.randn(shape, generator=gen).to(dev)
    f2 = torch.randn(shape, generator=gen).to(dev)
    g = OC.correlation_cuda(f1, f2, md, s2).normal_()
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    graph = OC.correlation_reference(a, b, md, s2)

    def plain_fb():
        torch.autograd.grad(OC.correlation_reference(a, b, md, s2), (a, b),
                            g)

    t = {
        "ms": median_cuda_ms(lambda: OC.correlation_cuda(f1, f2, md, s2),
                             iters=CORR_ITERS),
        "bwd_ms": median_cuda_ms(
            lambda: OC.correlation_backward_cuda(g, f1, f2, md, s2),
            iters=CORR_ITERS),
        "clip_ms": median_cuda_ms(
            lambda: OC.correlation_cuda(c1, c2, md, s2), iters=CORR_ITERS),
        "plain_ms": median_cuda_ms(
            lambda: OC.correlation_reference(f1, f2, md, s2), 3, 1),
        "plain_fb_ms": median_cuda_ms(plain_fb, 3, 1),
        "plain_bwd_ms": median_cuda_ms(lambda: torch.autograd.grad(
            graph, (a, b), g, retain_graph=True), 3, 1),
        "copy_ms": median_cuda_ms(lambda: (
            f1.contiguous(memory_format=torch.channels_last),
            f2.contiguous(memory_format=torch.channels_last))),
    }
    t["fb_ms"] = t["ms"] + t["bwd_ms"]
    t["bound_ms"], t["bound_by"], t["bound_rate"] = corr_reported_bound(
        shape, md, s2, False)
    t["bwd_bound_ms"], t["bwd_bound_by"], t["bwd_bound_rate"] = \
        corr_reported_bound(shape, md, s2, True)
    t["clip_bound_ms"], _, clip_rate = corr_reported_bound(
        FLOWNET2_CORR_SHAPE, md, s2, False)
    fp32, _ = corr_bound_ms(shape, md, s2, 4, False)
    fp32_bwd, _ = corr_bound_ms(shape, md, s2, 4, True)
    log(f"[corr] {tuple(shape)} md {md} s2 {s2} float32, median ms: "
        f"forward kernel {t['ms']:.4f}, plain {t['plain_ms']:.3f}, bound "
        f"{t['bound_ms']:.4f} ({t['bound_by']}, {t['bound_rate']}; share "
        f"{t['bound_ms'] / t['ms']:.3f}; FP32 CUDA-core bound "
        f"{fp32:.4f}, share {fp32 / t['ms']:.3f}); forward+backward kernel "
        f"{t['fb_ms']:.4f}, plain {t['plain_fb_ms']:.3f}; backward kernel "
        f"{t['bwd_ms']:.4f}, plain {t['plain_bwd_ms']:.3f}, bound "
        f"{t['bwd_bound_ms']:.4f} ({t['bwd_bound_by']}, "
        f"{t['bwd_bound_rate']}; share "
        f"{t['bwd_bound_ms'] / t['bwd_ms']:.3f}; FP32 CUDA-core bound "
        f"{fp32_bwd:.4f}, share {fp32_bwd / t['bwd_ms']:.3f}); "
        f"a channels-last copy of f1 and f2 (not made: the kernel reads "
        f"NCHW) {t['copy_ms']:.4f} [{card}]")
    log(f"[corr] FlowNet2's clip shape {FLOWNET2_CORR_SHAPE} float32: "
        f"forward kernel {t['clip_ms']:.4f} ms, bound "
        f"{t['clip_bound_ms']:.4f} ({clip_rate}; share "
        f"{t['clip_bound_ms'] / t['clip_ms']:.3f}) [{card}]")
    return t


def flow_train(model: str, dtype: str, batches, seed: int, card: str
               ) -> dict:
    """1 warm-up and 3 timed harness steps at FLOW_BATCH x FLOW_SIZE²;
    checks finite loss and EPE, parameters that moved, and the
    correlation launches of each step."""
    from jafpro_tpu_torch.ops.correlation import correlation
    from jafpro_tpu_torch.train.flow_harness import make_flow_train_step

    init_fn, step_fn = make_flow_train_step(model, lr=1e-4,
                                            compute_dtype=dtype)
    state = init_fn(torch.Generator().manual_seed(seed))
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    times, metrics, launches = [], [], []
    for i, (pairs, flow) in enumerate(batches):
        correlation.launches = correlation.backward_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, pairs, flow)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        launches.append((correlation.launches,
                         correlation.backward_launches))
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(p0, p.detach())
                for p0, p in zip(before, state.model.parameters()))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"flow {model} {dtype}: a loss is not finite")
    if moved < len(before) // 2:
        raise AssertionError(f"flow {model} {dtype}: only {moved} of "
                             f"{len(before)} parameters moved")
    want = (1, 1) if model == "c" else (0, 0)
    if any(la != want for la in launches):
        raise AssertionError(f"flow {model} {dtype}: correlation launches "
                             f"per step {launches}, expected {want}")
    s_step = statistics.median(times)
    log(f"[flow] train {model} {dtype} batch {FLOW_BATCH} {FLOW_SIZE}²: "
        f"{s_step:.4f} s/step (median of {len(times)}: "
        + ", ".join(f"{t:.4f}" for t in times)
        + f"), {FLOW_BATCH / s_step:.2f} samples/s, peak {peak:.2f} GiB; "
        f"loss {metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f}, epe "
        f"{metrics[-1]['epe']:.4f}; correlation launches per step "
        f"(forward, backward) {launches[-1]}; {moved}/{len(before)} "
        f"parameters moved [{card}]")
    return {"s_step": s_step, "peak": peak, "launches": launches}


def flow_clip(seed: int, T: int = 30, S: int = 256) -> np.ndarray:
    """A seeded (T, 3, S, S) clip in [0, 255]: smooth noise moved by a
    smooth flow that grows frame by frame."""
    from jafpro_tpu_torch.ops.sampling import resample2d
    from jafpro_tpu_torch.train.flow_harness import resize_linear_nhwc

    rng = np.random.RandomState(seed)
    base = resize_linear_nhwc(rng.rand(1, S // 8, S // 8, 3).astype(
        np.float32), (S, S))
    flow = resize_linear_nhwc(rng.randn(1, 4, 4, 2).astype(np.float32),
                              (S, S)) * 0.5
    img = torch.from_numpy(base).permute(0, 3, 1, 2).repeat(T, 1, 1, 1)
    fl = torch.from_numpy(flow).permute(0, 3, 1, 2) * torch.arange(
        T, dtype=torch.float32).view(T, 1, 1, 1)
    with torch.no_grad():
        return (255.0 * resample2d(img, fl)).numpy()


def flownet2_clip(seed: int, card: str) -> dict:
    """FlowNet2 (eval, float32) on the 29 consecutive pairs of one seeded
    30-frame 256² clip in one batch: ms per clip and launches."""
    from jafpro_tpu_torch.models.common import init_params_
    from jafpro_tpu_torch.models.flownet import FlowNet2, flownet2_preprocess
    from jafpro_tpu_torch.ops.correlation import correlation

    dev = torch.device("cuda")
    clip = torch.from_numpy(flow_clip(seed)).to(dev)
    frames = torch.stack([clip[:-1], clip[1:]], 2)      # (29, 3, 2, S, S)
    net = init_params_(FlowNet2(), torch.Generator().manual_seed(seed))
    net = net.to(dev).eval()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        x = flownet2_preprocess(frames)
        correlation.launches = 0
        out = net(x)
        torch.cuda.synchronize()
        launches = correlation.launches
        ms, times = median_ms(lambda: net(flownet2_preprocess(frames)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if out.shape != (29, 2, 256, 256) or not bool(out.isfinite().all()):
        raise AssertionError(f"FlowNet2 output {tuple(out.shape)} is wrong "
                             "or not finite")
    if launches != 1:
        raise AssertionError(f"FlowNet2 launched the correlation "
                             f"{launches} times on one clip")
    log(f"[flow] FlowNet2 float32, 29 pairs of a 30-frame 256² clip: "
        f"{ms:.2f} ms per clip (median of 3: "
        + ", ".join(f"{t:.2f}" for t in times)
        + f"), {29e3 / ms:.1f} pairs/s, peak {peak:.2f} GiB, correlation "
        f"launches per clip {launches} [{card}]")
    return {"ms": ms, "launches": launches}


def flow_sgd_step_on(dev: str, seed: int, batch: int) -> tuple:
    """One SGD (lr 1e-3) harness step of FlowNetC at 64², float32, from
    seeded weights and batch norm statistics: (before, after (flax
    trees), metrics)."""
    from jafpro_tpu_torch.bridge import flax_from_state_dict
    from jafpro_tpu_torch.train.flow_harness import (
        make_flow_train_step, synthetic_flow_batch)

    pairs, flow = synthetic_flow_batch(np.random.RandomState(seed),
                                       batch=batch, size=64)
    init_fn, step_fn = make_flow_train_step("c", lr=1e-3, device=dev)
    state = init_fn(torch.Generator().manual_seed(seed))
    state.opt = torch.optim.SGD(state.model.parameters(), 1e-3)
    before = flax_from_state_dict(state.model)
    state, m = step_fn(state, pairs, flow)
    return before, flax_from_state_dict(state.model), {
        k: float(v) for k, v in m.items()}


def flow_reference(seed: int) -> None:
    """Card against CPU at 64²: FlowNetC's eval forward, and one SGD
    harness step (loss, EPE, each module's update)."""
    from jafpro_tpu_torch.checkpoints import flatten
    from jafpro_tpu_torch.models.common import init_params_
    from jafpro_tpu_torch.models.flownet import FlowNetC

    net = init_params_(FlowNetC(), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    net.eval()
    x = torch.rand((FLOW_REF_BATCH, 6, 64, 64), generator=gen)
    with torch.no_grad():
        want = net(x[:, :3], x[:, 3:])
        got = net.cuda()(x[:, :3].cuda(), x[:, 3:].cuda()).cpu()
    fwd = float((got - want).abs().max() / want.abs().max())
    b_gpu, a_gpu, m_gpu = flow_sgd_step_on("cuda", seed, FLOW_REF_BATCH)
    b_cpu, a_cpu, m_cpu = flow_sgd_step_on("cpu", seed, FLOW_REF_BATCH)
    worst_m = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    b0, ag, ac = (flatten(t["params"]) for t in (b_cpu, a_gpu, a_cpu))
    err: dict = {}
    for name, p0 in b0.items():
        e = err.setdefault(name.split("/")[0], [0.0, 0.0])
        du, dc = ag[name] - p0, ac[name] - p0
        e[0] += float(np.square(du - dc, dtype=np.float64).sum())
        e[1] += float(np.square(dc, dtype=np.float64).sum())
    rel = {k: (d / n) ** 0.5 for k, (d, n) in err.items() if n > 0}
    worst = max(rel, key=rel.get)
    log(f"[flow] card vs CPU, FlowNetC 64², batch {FLOW_REF_BATCH}, float32, "
        f"TF32 off: forward max rel {fwd:.3e} (tolerance {FLOW_FWD_RTOL}); "
        f"one SGD step: metrics max rel {worst_m:.3e} (tolerance "
        f"{FLOW_METRIC_RTOL}), update rel L2 per module max {rel[worst]:.3e} "
        f"({worst}; tolerance {FLOW_UPDATE_RTOL}), median "
        f"{statistics.median(rel.values()):.3e} over {len(rel)} modules")
    if not (fwd <= FLOW_FWD_RTOL and worst_m <= FLOW_METRIC_RTOL
            and rel[worst] <= FLOW_UPDATE_RTOL):
        raise AssertionError("the card's FlowNetC disagrees with the CPU's")


def phase_flow(seed: int, card: str) -> list:
    """Phase 9. Returns the correlation kernels' JSON records."""
    from jafpro_tpu_torch.ops.correlation import correlation
    from jafpro_tpu_torch.train.flow_harness import synthetic_flow_batch

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed + 90)
    errs = {name: check_corr_scene(name, shape, md, s2, gen)
            for name, shape, md, s2 in CORR_SCENES}
    _, shape, md, s2 = CORR_SCENES[0]
    t = time_corr(shape, md, s2, gen, card)

    # the main path: the harness trains FlowNetC (and FlowNetSD), then
    # FlowNet2 runs a clip; the counts are reset just before each run
    rng = np.random.RandomState(seed + 91)
    batches = [synthetic_flow_batch(rng, FLOW_BATCH, FLOW_SIZE)
               for _ in range(4)]
    train = {(m, d): flow_train(m, d, batches, seed, card)
             for m in ("c", "sd") for d in ("float32", "bfloat16")}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    clip = flownet2_clip(seed, card)
    flow_reference(seed)
    fwd = sum(la[0] for k, v in train.items() if k[0] == "c"
              for la in v["launches"]) + clip["launches"]
    bwd = sum(la[1] for k, v in train.items() if k[0] == "c"
              for la in v["launches"])
    if fwd < 1 or bwd < 1:
        raise AssertionError("the flow path never launched the correlation "
                             "kernels")
    log(f"[flow] phase 9 took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    worst = max(e["max_abs_err"] for e in errs.values())
    worst_b = max(e["bwd_max_abs_err"] for e in errs.values())
    return [
        {"name": "correlation", "route": "cuda", "source": CORR_SOURCE,
         "replaces": CORR_REPLACES, "launches": fwd,
         "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "bound_rate": t["bound_rate"],
         "library_ms": None, "flownet2_shape_ms": t["clip_ms"],
         "fwd_bwd_ms": t["fb_ms"],
         "plain_fwd_bwd_ms": t["plain_fb_ms"],
         "channels_last_copy_ms": t["copy_ms"],
         "s_step_c_float32": train[("c", "float32")]["s_step"],
         "s_step_c_bfloat16": train[("c", "bfloat16")]["s_step"],
         "flownet2_clip_ms": clip["ms"]},
        {"name": "correlation_backward", "route": "cuda",
         "source": CORR_SOURCE, "replaces": CORR_REPLACES + " (its VJP)",
         "launches": bwd, "max_abs_err": worst_b,
         "ms": t["bwd_ms"], "plain_ms": t["plain_bwd_ms"],
         "bound_ms": t["bwd_bound_ms"], "bound_by": t["bwd_bound_by"],
         "bound_rate": t["bwd_bound_rate"], "library_ms": None},
    ]


# --------------------------------------------------------------- phase 10

ZOO_RTOL = 1e-4      # card vs CPU, of the largest output
ZOO_SN_ATOL = 1e-5   # card vs CPU, spectral-norm u and sigma
ZOO_PARTS = (1, 4, 24, 200, 200, 3)   # 4 references, 24 parts of 200 px


def zoo_specs() -> list:
    """The zoo, one entry per module: (name, build(small, **kw) -> module,
    inputs(small) -> args, arrays as shapes to fill). Full size is the
    reference width: 256² images, the 800x1200 atlas, (1, 4, 24, 200, 200,
    3) part stacks, RRDB at 64 features, growth 32, 128², the recurrences
    at hidden 64, 64², T = 4. Small is a CPU-sized cut of the same net."""
    from jafpro_tpu_torch.models import ablations as A
    from jafpro_tpu_torch.models.accumulate import AccumulateGRU
    from jafpro_tpu_torch.models.conv_lstm import ConvGRU, ConvLSTM
    from jafpro_tpu_torch.models.crn import CRN, CRNSmall

    def img(c, full, small=32):
        return lambda sm: [(1, c, small if sm else full[0],
                            small if sm else full[-1])]

    def parts(sm):
        return [(1, 2, 2, 16, 16, 3) if sm else ZOO_PARTS]

    def seq(sm):
        return [(1, 4, 3) + ((16, 16) if sm else (64, 64)), "mask"]

    def crn_in(c, extra=()):
        return lambda sm: [(1, c) + ((64, 64) if sm else (256, 256)),
                           64 if sm else 256, *extra]

    def st_in(sm):
        S = 64 if sm else 256
        return [(1, 6, S, S), (1, 6, S, S), S, ("flow", (1, 2, S, S))]

    def n_parts(sm):
        return 2 if sm else 24

    def rb(sm):
        return {"residual_blocks": 1} if sm else {}

    return [
        ("ConvLSTM", lambda sm, **k: ConvLSTM(3, 8 if sm else 64, **k), seq),
        ("ConvGRU", lambda sm, **k: ConvGRU(3, 8 if sm else 64, **k), seq),
        ("ConvGRU(modgru)", lambda sm, **k: ConvGRU(
            3, 8 if sm else 64, cell="modgru", **k), seq),
        ("CRN", lambda sm, **k: CRN(fg=True, **k), crn_in(3)),
        ("CRNSmall", lambda sm, **k: CRNSmall(fg=True, **k), crn_in(3)),
        ("AccumulateGRU", lambda sm, **k: AccumulateGRU(n_parts(sm), **k),
         lambda sm: parts(sm) + ["refmask"]),
        ("AccumulateGRU(modgru)", lambda sm, **k: AccumulateGRU(
            n_parts(sm), cell="modgru", **k),
         lambda sm: parts(sm) + ["refmask"]),
        ("UNetSE", lambda sm, **k: A.UNetSE(**k), img(3, (200,))),
        ("UNetGenerator", lambda sm, **k: A.UNetGenerator(**k),
         img(3, (256,), 64)),
        ("UNetTA", lambda sm, **k: A.UNetTA(**k),
         lambda sm: [(1, 3, 32, 48) if sm else (1, 3, 800, 1200)]),
        ("AccumulatePlain", lambda sm, **k: A.AccumulatePlain(
            n_parts(sm), refs=2 if sm else 4, **k), parts),
        ("AccumulateMaxFusion", lambda sm, **k: A.AccumulateMaxFusion(
            n_parts(sm), **k), parts),
        ("AccumulateAvgFusion", lambda sm, **k: A.AccumulateAvgFusion(
            n_parts(sm), **k), parts),
        ("AccumulateMask", lambda sm, **k: A.AccumulateMask(
            n_parts(sm), refs=2 if sm else 4, **k), parts),
        ("CodeEncoder", lambda sm, **k: A.CodeEncoder(**k),
         lambda sm: [(1, 3, 200, 200)]),
        ("CodeDecoder", lambda sm, **k: A.CodeDecoder(**k),
         lambda sm: [(1, 512)]),
        ("MaxFusionModule", lambda sm, **k: A.MaxFusionModule(
            n_parts(sm), **k),
         lambda sm: [(1, 2, 2, 200, 200, 3) if sm else ZOO_PARTS]),
        ("Vid2VidResnetBlock", lambda sm, **k: A.Vid2VidResnetBlock(
            8 if sm else 256, **k), lambda sm: [
                (1, 8, 16, 16) if sm else (1, 256, 64, 64)]),
        ("PredictiveModule", lambda sm, **k: A.PredictiveModule(
            n_blocks=1 if sm else 6, **k), img(9, (256,))),
        ("BlendingModule", lambda sm, **k: A.BlendingModule(**k),
         lambda sm: img(3, (256,))(sm) * 3),
        ("EdgeConnectResnetBlock", lambda sm, **k: A.EdgeConnectResnetBlock(
            8 if sm else 256, spectral=True, **k), lambda sm: [
                (1, 8, 16, 16) if sm else (1, 256, 64, 64)]),
        ("InpaintGenerator", lambda sm, **k: A.InpaintGenerator(
            **rb(sm), **k), img(6, (256,))),
        ("EdgeGenerator", lambda sm, **k: A.EdgeGenerator(**rb(sm), **k),
         img(3, (256,))),
        ("PatchDiscriminator70", lambda sm, **k: A.PatchDiscriminator70(**k),
         img(3, (256,))),
        ("NLayerDiscriminator", lambda sm, **k: A.NLayerDiscriminator(
            ndf=16 if sm else 64, **k), img(3, (256,))),
        ("PixelDiscriminator", lambda sm, **k: A.PixelDiscriminator(
            ndf=16 if sm else 64, **k), img(3, (256,))),
        ("EDSRResBlock", lambda sm, **k: A.EDSRResBlock(8 if sm else 64, **k),
         lambda sm: [(1, 8, 16, 16) if sm else (1, 64, 128, 128)]),
        ("ResidualDenseBlock5C", lambda sm, **k: A.ResidualDenseBlock5C(
            8 if sm else 64, 4 if sm else 32, **k),
         lambda sm: [(1, 8, 16, 16) if sm else (1, 64, 128, 128)]),
        ("RRDB", lambda sm, **k: A.RRDB(8 if sm else 64, 4 if sm else 32,
                                        **k),
         lambda sm: [(1, 8, 16, 16) if sm else (1, 64, 128, 128)]),
        ("AutoEncoder", lambda sm, **k: A.AutoEncoder(**k),
         img(3, (256,), 64)),
        ("CRNAuto", lambda sm, **k: A.CRNAuto(**k), lambda sm: crn_in(6, [
            (1, 3) + ((64, 64) if sm else (256, 256))])(sm)),
        ("SpatioTempoCRN", lambda sm, **k: A.SpatioTempoCRN(
            ngf=32 if sm else 512, **k), st_in),
    ]


SN_NETS = ("EdgeConnectResnetBlock", "EdgeGenerator", "PatchDiscriminator70")


def zoo_inputs(spec, small: bool, seed: int, dev) -> list:
    """The module's seeded inputs on ``dev``: uniform [-1, 1) arrays, a
    reference mask with one masked step, a flow of 0.05 grid units."""
    rng = np.random.RandomState(seed)
    args = []
    for a in spec(small):
        if a == "mask":
            m = np.ones((1, 4), np.float32)
            m[0, 2] = 0.0
            args.append(torch.from_numpy(m).to(dev))
        elif a == "refmask":
            n = args[0].shape[1]
            args.append(torch.ones((1, n), device=dev))
        elif isinstance(a, int):
            args.append(a)
        else:
            scale = 1.0
            if a[0] == "flow":
                a, scale = a[1], 0.05
            args.append(torch.from_numpy(scale * rng.uniform(
                -1, 1, a).astype(np.float32)).to(dev))
    return args


def zoo_outputs(out) -> list:
    """The output tensors of one call, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    flat = []
    for o in out:
        flat += zoo_outputs(o)
    return flat


def sn_state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if k.endswith((".u", ".sigma"))}


def zoo_reference(seed: int) -> float:
    """Every zoo module at a small size from the same seeded weights on the
    card and on the CPU (spectral-norm nets with ``update_sn=True``):
    outputs within ZOO_RTOL of the largest, updated ``u`` and ``sigma``
    within ZOO_SN_ATOL. Returns the worst relative output gap."""
    worst = 0.0
    for i, (name, build, spec) in enumerate(zoo_specs()):
        outs, states = [], []
        for dev in ("cuda", "cpu"):
            net = build(True, device=dev,
                        generator=torch.Generator().manual_seed(seed + i))
            kw = {"update_sn": True} if name in SN_NETS else {}
            with torch.no_grad():
                outs.append([o.float().cpu() for o in zoo_outputs(
                    net(*zoo_inputs(spec, True, seed + i, dev), **kw))])
            states.append({k: v.cpu() for k, v in sn_state(net).items()})
        for a, b in zip(*outs):
            gap = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            worst = max(worst, gap)
            if not gap <= ZOO_RTOL:
                raise AssertionError(f"{name}: card vs CPU {gap:.3e}")
        for k, v in states[1].items():
            d = float((states[0][k] - v).abs().max())
            if not d <= ZOO_SN_ATOL:
                raise AssertionError(f"{name}.{k}: card vs CPU {d:.3e}")
    return worst


def phase_zoo(seed: int, card: str) -> None:
    """Phase 10: each zoo module once at its reference width on the card
    (float32, TF32 off, inference under ``no_grad``): shapes and finite
    outputs, median ms of 3 after a warm-up, peak memory; the
    spectral-norm nets once more with ``update_sn=True``; then every
    module card vs CPU at a small size (``zoo_reference``)."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (name, build, spec) in enumerate(zoo_specs()):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = build(False, device="cuda",
                    generator=torch.Generator().manual_seed(seed + i))
        args = zoo_inputs(spec, False, seed + i, "cuda")
        with torch.no_grad():
            outs = zoo_outputs(net(*args))
            ms, times = median_ms(lambda: net(*args))
        for o in outs:
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{name}: non-finite output")
        shapes = [tuple(o.shape) for o in outs]
        expect = {
            "MaxFusionModule": ZOO_PARTS[0:1] + ZOO_PARTS[2:],
            "UNetTA": (1, 3, 800, 1200),
            "CodeEncoder": (1, 256),
            "CodeDecoder": (1, 3, 200, 200),
            "AutoEncoder": (1, 128, 4, 4),
        }.get(name)
        if name.startswith("Accumulate"):
            expect = ZOO_PARTS[0:1] + ZOO_PARTS[2:]
        if expect is not None and shapes[0] != tuple(expect):
            raise AssertionError(f"{name}: output {shapes[0]}")
        in_shapes = [tuple(a.shape) for a in args
                     if isinstance(a, torch.Tensor)]
        if expect is None and name not in ("PatchDiscriminator70",
                                           "NLayerDiscriminator"):
            if shapes[0][-2:] != in_shapes[0][-2:]:
                raise AssertionError(f"{name}: output {shapes[0]}")
        n_params = sum(p.numel() for p in net.parameters())
        log(f"[zoo] {name} in {in_shapes[0]}: out {shapes[0]}, "
            f"{n_params / 1e6:.2f} M params, median {ms:.3f} ms "
            f"({', '.join(f'{t:.3f}' for t in times)}), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
        if name in SN_NETS[1:]:
            before = sn_state(net)
            with torch.no_grad():
                net(*args, update_sn=True)
            after = sn_state(net)
            same = [k for k in before if torch.equal(before[k], after[k])]
            if same or len(before) < 5:
                raise AssertionError(f"{name}: update_sn left {same}")
            log(f"[zoo] {name} update_sn=True: {len(before)} spectral-norm "
                f"buffers (u, sigma) updated")
        del net, args, outs
    worst = zoo_reference(seed)
    log(f"[zoo] {len(zoo_specs())} modules card vs CPU at a small size: "
        f"worst output gap {worst:.3e} of the largest (<= {ZOO_RTOL}); "
        f"spectral-norm u, sigma within {ZOO_SN_ATOL} [{card}]")
    log(f"[zoo] phase 10 took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")


# ---------------------------------------------------------------------------
# phase 11: data parallelism (ranks of jafpro_tpu_torch.parallel)
# ---------------------------------------------------------------------------

DP_TIMEOUT_S = 300   # bound on each collective of a rank


def float32_on_rank() -> None:
    """A rank starts with PyTorch's TF32 defaults; float32 means float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trained_params(pipe, names) -> dict:
    """A copy of modules ``names`` of ``pipe``, by ``state_dict`` name."""
    return {f"{n}.{k}": v.detach().clone() for n in names
            for k, v in getattr(pipe, n).state_dict().items()}


def update_rel_l2(before: dict, after: dict, ref_after: dict) -> tuple:
    """Per module: the L2 norm of (update - reference update) over that of
    the reference update; and the modules that moved but not in the
    reference."""
    err: dict = {}
    for k, p0 in before.items():
        du = after[k].double() - p0.double()
        dr = ref_after[k].double() - p0.double()
        e = err.setdefault(k.split(".")[0], [0.0, 0.0])
        e[0] += float(torch.square(du - dr).sum())
        e[1] += float(torch.square(dr).sum())
    return ({m: (d / n) ** 0.5 for m, (d, n) in err.items() if n > 0},
            sorted(m for m, (d, n) in err.items() if n == 0 and d > 0))


def state_digest(module) -> str:
    """A hash of every parameter and buffer of ``module``, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for name, v in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(v.detach().reshape(-1).contiguous().cpu().view(
            torch.uint8).numpy())
    return h.hexdigest()


def dp_sgd_rank(mesh, stages, seed: int, batch: int) -> dict:
    """On one rank: one SGD step of each of ``stages`` (``sgd_setup``, the
    ragged global batch of ``batch``) through ``data_parallel_jit``, from
    the same seeded weights each time; rank 0 then takes the same step
    without a mesh on the whole batch and compares the updates."""
    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.geometry import rasterizer as R
    from jafpro_tpu_torch.parallel import data_parallel_jit, replicate
    from jafpro_tpu_torch.train.common import TrainState, to_device

    float32_on_rank()
    pipe, b = sgd_setup(mesh.device, seed, batch, ragged=True)
    replicate(mesh, pipe)
    start = {k: v.clone() for k, v in pipe.state_dict().items()}
    poses = count_poses(pipe.flow_engine)
    sgd = lambda ps, lr: torch.optim.SGD(ps, 1e-3)  # noqa: E731
    out = {}
    for stage in stages:
        pipe.load_state_dict(start)
        step, lrs = cli.make_step(pipe, stage)
        before = trained_params(pipe, lrs)
        sync(mesh.device)
        R.rasterize_fim_wim.launches = 0
        poses.clear()
        _, m = data_parallel_jit(step, mesh)(
            TrainState(pipe, lrs, optimizer=sgd), b)
        sync(mesh.device)
        r = {"metrics": {k: float(v) for k, v in m.items()},
             "launches": R.rasterize_fim_wim.launches, "poses": list(poses),
             "digest": state_digest(pipe)}
        if mesh.rank == 0:
            after = trained_params(pipe, lrs)
            pipe.load_state_dict(start)
            _, m_ref = step(TrainState(pipe, lrs, optimizer=sgd),
                            to_device(b, mesh.device))
            r["ref_metrics"] = {k: float(v) for k, v in m_ref.items()}
            r["update_rel"], r["moved_alone"] = update_rel_l2(
                before, after, trained_params(pipe, lrs))
        out[stage] = r
    del pipe.flow_engine.render_fim_wim
    return out


def check_dp_sgd(what: str, ranks: list, stages, batch: int,
                 card: str) -> int:
    """Phase 11's checks of ``dp_sgd_rank``'s results; returns the
    rasterizer launches of the sharded steps."""
    world = len(ranks)
    launches = 0
    for stage in stages:
        rs = [r[stage] for r in ranks]
        r0 = rs[0]
        worst_m = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-12)
                      for k, v in r0["ref_metrics"].items())
        rel = r0["update_rel"]
        log(f"[dp] {what}: stage {stage} SGD step (64 px, global batch "
            f"{batch}, {batch // world} per rank, float32, TF32 off) vs one "
            f"process at batch {batch}: metrics max rel {worst_m:.3e} "
            f"(tolerance {TRAIN_METRIC_RTOL}); update rel L2 per module "
            + ", ".join(f"{k} {v:.3e}" for k, v in sorted(rel.items()))
            + f" (tolerance {TRAIN_UPDATE_RTOL}); rasterize_fim_wim "
            f"launches per rank {[r['launches'] for r in rs]}, poses "
            f"{[r['poses'] for r in rs]}; replicas bitwise equal "
            f"{len({r['digest'] for r in rs}) == 1} [{card}]")
        if set(r0["metrics"]) != set(r0["ref_metrics"]) or not (
                worst_m <= TRAIN_METRIC_RTOL
                and max(rel.values()) <= TRAIN_UPDATE_RTOL):
            raise AssertionError(f"{what}: the sharded stage-{stage} step "
                                 "disagrees with one process")
        if r0["moved_alone"]:
            raise AssertionError(f"{what}: {r0['moved_alone']} moved in "
                                 "the sharded step only")
        if len({r["digest"] for r in rs}) != 1:
            raise AssertionError(f"{what}: the replicas differ")
        if any(r["metrics"] != r0["metrics"] for r in rs):
            raise AssertionError(f"{what}: the ranks logged other metrics")
        want = (1, [batch // world]) if stage == 4 else (0, [])
        if any((r["launches"], r["poses"]) != want for r in rs):
            raise AssertionError(f"{what}: stage {stage} launched the "
                                 "rasterizer other than once per rank on "
                                 "its own poses")
        launches += sum(r["launches"] for r in rs)
    return launches


def dp_reference(seed: int, stages=(4,), card: str = "") -> int:
    """Check (b) of phase 11 alone: two gloo ranks sharing ``cuda:0`` take
    the 64 px SGD steps of ``stages`` at global batch
    ``TRAIN_REF_BATCH[4]``, held to one process; returns the rasterizer
    launches of the sharded steps."""
    from jafpro_tpu_torch.parallel import spawn

    B = TRAIN_REF_BATCH[4]
    with tempfile.TemporaryDirectory() as root:
        ranks = spawn(dp_sgd_rank, 2, backend="gloo",
                      devices=["cuda:0", "cuda:0"], args=(stages, seed, B),
                      workdir=root, timeout_s=DP_TIMEOUT_S)
    return check_dp_sgd("(b) gloo, 2 ranks on one card", ranks, stages, B,
                        card)


def dp_card_rank(mesh, seed: int, shard_dir: str, pack_dir: str, faces,
                 verts, sgd_batch: int) -> dict:
    """On one of two ranks that share the card (gloo): the 64 px SGD
    steps of stages 1 and 4 (``dp_sgd_rank``); stage 4 at ``Config()``
    widths in bfloat16 from the packed records (1 warm-up and 3 timed
    steps of global batch 4); then serving the packed clips (this rank's
    share, one clip per batch) in bfloat16 and in float32, and
    ``generate_batch`` over the ranks in float32 (one clip per rank)."""
    import argparse as _argparse

    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.geometry import rasterizer as R
    from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
    from jafpro_tpu_torch.infer import VideoGenerator, stack_clips
    from jafpro_tpu_torch.parallel import (
        data_parallel_jit, replicate, shard_batch)
    from jafpro_tpu_torch.pipeline import JAFProPipeline
    from jafpro_tpu_torch.train.common import TrainState, apply_curriculum

    out = {"sgd": dp_sgd_rank(mesh, (1, 4), seed, sgd_batch)}
    dev = mesh.device
    cfg = Config()   # bfloat16, batch 4: the CLI's defaults
    engine = SMPLFlowEngine(faces=faces, image_size=cfg.image_size)

    # ---- (c) stage 4 at full width from the packed records ----
    pipe = JAFProPipeline(cfg, flow_engine=engine, device=dev,
                          generator=torch.Generator().manual_seed(seed))
    replicate(mesh, pipe)
    start = {k: v.clone() for k, v in pipe.state_dict().items()}
    step, lrs = cli.make_step(pipe, 4)
    step = data_parallel_jit(step, mesh)
    state = TrainState(pipe, lrs)
    args = _argparse.Namespace(shards=shard_dir, stage=4, seed=seed,
                               synthetic=False)
    rng = np.random.RandomState(seed)
    next_raw, close = cli._raw_batch_source(args, cfg, rng, verts,
                                            in_order=True)
    before = snapshot(pipe)
    poses = count_poses(engine)
    torch.cuda.reset_peak_memory_stats(dev)
    times, launches, losses = [], [], []
    try:
        for _ in range(4):
            batch = shard_batch(mesh, apply_curriculum(
                dict(next_raw()), 4, rng, cfg.maximum_ref_frames))
            sync(dev)
            R.rasterize_fim_wim.launches = 0
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync(dev)
            times.append(time.perf_counter() - t0)
            launches.append(R.rasterize_fim_wim.launches)
            losses.append({k: float(v) for k, v in m.items()})
    finally:
        close()
        del engine.render_fim_wim
    moved, same = moved_modules(before, pipe)
    out["full"] = {"times": times, "launches": launches, "poses": poses,
                   "losses": losses, "moved": moved, "same": same,
                   "lrs": set(lrs), "digest": state_digest(pipe),
                   "peak": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del state, before
    torch.cuda.empty_cache()   # the two ranks share the card's memory

    # ---- (d) serving this rank's share of the packed clips ----
    pipe.load_state_dict(start)
    del start
    vids, load = cli.open_clip_source(cfg, cfg.maximum_ref_frames, pack_dir)
    groups = cli.group_items(vids, 1)

    def serve(gen) -> dict:
        written: dict = {}

        def write(group, result):
            written.update(cli.fetch_clips(group, result, cli.STREAMS))

        R.rasterize_fim_wim.launches = 0
        stats = cli.serve_share(groups, load, cli.generate_group(gen),
                                write, mesh)
        return {"written": written, "stats": stats,
                "launches": R.rasterize_fim_wim.launches,
                "mine": len(groups[mesh.rank::mesh.world])}

    out["serve"] = {"bfloat16": serve(cli.serving_generator(pipe, cfg))}
    del pipe
    torch.cuda.empty_cache()
    float32_on_rank()
    cfg32 = Config(compute_dtype="float32")
    pipe32 = JAFProPipeline(cfg32, flow_engine=engine, device=dev,
                            generator=torch.Generator().manual_seed(seed))
    replicate(mesh, pipe32)
    out["serve"]["float32"] = serve(cli.serving_generator(pipe32, cfg32))

    # ---- (d) generate_batch over the ranks, float32: one clip each ----
    fgen = VideoGenerator(pipe32, frame_batch=cfg.num_frames,
                          flow_mode="batch")
    clips = load(vids[:mesh.world])
    whole = fgen.generate_batch(stack_clips(clips), mesh)
    d = 0.0
    for i in range(mesh.rank, len(clips), mesh.world):
        d = max(d, max_diff({k: v[i] for k, v in whole.items()},
                            fgen(clips[i])))
    out["batch"] = {"shape": tuple(whole["final"].shape), "diff": d}
    return out


def phase_dp(seed: int, clip: dict, faces: np.ndarray, alone: dict,
             card: str) -> int:
    """Phase 11: data parallelism. Returns the rasterizer launches of the
    ranks' main-path steps and batches."""
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = Config()
    B = TRAIN_REF_BATCH[4]
    with tempfile.TemporaryDirectory() as root:
        # (a) NCCL at world 1
        ranks = spawn(dp_sgd_rank, 1, backend="nccl", devices=["cuda:0"],
                      args=((4,), seed, B), workdir=root,
                      timeout_s=DP_TIMEOUT_S)
        launches = check_dp_sgd("(a) NCCL, world 1", ranks, (4,), B, card)

        # (b)-(d) two gloo ranks on the one card
        shard_dir = os.path.join(root, "interval")
        os.makedirs(shard_dir)
        pack_train_records(cfg, seed + 20, 3, 8, clip["verts"],
                           clip["cams"], os.path.join(
                               shard_dir, "train-interval-00000.shard"))
        pack_dir = os.path.join(root, "clips")
        pack_clips(seed, 4, cfg.num_frames, cfg.maximum_ref_frames,
                   cfg.image_size, cfg.part_size, cfg.num_parts, pack_dir)
        t0 = time.perf_counter()
        ranks = spawn(dp_card_rank, 2, backend="gloo",
                      devices=["cuda:0", "cuda:0"],
                      args=(seed, shard_dir, pack_dir, faces,
                            clip["verts"][0], B),
                      workdir=root, timeout_s=DP_TIMEOUT_S)
        log(f"[dp] 2 gloo ranks on one card: (b)-(d) in "
            f"{time.perf_counter() - t0:.1f} s, start-up included")
        launches += check_dp_sgd("(b) gloo, 2 ranks on one card",
                                 [r["sgd"] for r in ranks], (1, 4), B, card)

        # (c) the slice at full width
        fulls = [r["full"] for r in ranks]
        for rank, f in enumerate(fulls):
            log(f"[dp] (c) stage 4 bfloat16 at Config() widths, global "
                f"batch 4 as 2 ranks x 2 sharing one card (gloo; a "
                f"correctness run, not a scaling number): rank {rank} step "
                f"times {[round(t, 4) for t in f['times']]} s (first is "
                f"warm-up), {statistics.median(f['times'][1:]):.4f} s/step "
                f"(median of 3); peak memory {f['peak']:.2f} GiB; "
                f"rasterize_fim_wim launches per step {f['launches']}, "
                f"poses per launch {f['poses']}; moved {sorted(f['moved'])}; "
                f"unchanged {sorted(f['same'])} [{card}]")
        log("[dp] (c) losses (global, equal on both ranks): " + "; ".join(
            ", ".join(f"{k} {v:.5g}" for k, v in m.items())
            for m in fulls[0]["losses"]))
        for f in fulls:
            if not all(np.isfinite(v) for m in f["losses"] for v in
                       m.values()):
                raise AssertionError("(c): a loss is not finite")
            if f["moved"] != f["lrs"] or "bg" not in f["same"]:
                raise AssertionError(f"(c): moved {f['moved']}, trains "
                                     f"{f['lrs']}")
            if f["launches"] != [1] * 4 or f["poses"] != [2] * 4:
                raise AssertionError("(c): a rank's step did not rasterize "
                                     "its 2 poses in one kernel launch")
            if f["losses"] != fulls[0]["losses"]:
                raise AssertionError("(c): the ranks logged other losses")
        if len({f["digest"] for f in fulls}) != 1:
            raise AssertionError("(c): the replicas differ after 4 steps")
        launches += sum(sum(f["launches"]) for f in fulls)

        # (d) serving and generate_batch over the ranks
        T, S = cfg.num_frames, cfg.image_size
        for dtype in ("bfloat16", "float32"):
            d, n = 0, 0
            for r in ranks:
                sv = r["serve"][dtype]
                for vid, frames in sv["written"].items():
                    for k, c in (("final", 3), ("coarse", 3), ("mask", 1),
                                 ("tsf", 3)):
                        if frames[k].dtype != np.uint8 or frames[k].shape \
                                != (T, S, S, c):
                            raise AssertionError(f"(d): served {vid} {k}")
                    d = max(d, u8_diff(frames, alone[dtype][vid]))
                    n += 1
                if sv["launches"] != sv["mine"]:
                    raise AssertionError("(d): a served batch did not "
                                         "rasterize in one launch")
                launches += sv["launches"]
            st = ranks[0]["serve"][dtype]["stats"]
            log(f"[dp] (d) 2 gloo ranks on one card served {st['clips']} "
                f"clips ({dtype}, 1 per batch, round-robin; launches per "
                f"rank {[r['serve'][dtype]['launches'] for r in ranks]}): "
                f"slowest rank's loop {st['loop_seconds']:.4f} s; vs phase "
                f"6's one process, each clip alone: max {d} LSB (tolerance "
                f"1) over {n} clips [{card}]")
            if n != 4 or st["clips"] != 4:
                raise AssertionError("(d): the ranks did not serve every "
                                     "clip once")
            if not d <= 1:
                raise AssertionError("(d): the ranks' served clips disagree "
                                     "with one process")
        db = max(r["batch"]["diff"] for r in ranks)
        log(f"[dp] (d) generate_batch(clips, mesh) float32 over 2 ranks: "
            f"{ranks[0]['batch']['shape']} on each; vs per-clip generation "
            f"max abs {db:.3e} (tolerance 1e-4)")
        if not db <= 1e-4 or any(r["batch"]["shape"][0] != 2 for r in ranks):
            raise AssertionError("(d): generate_batch over the ranks "
                                 "disagrees with per-clip generation")

        # (e) NCCL across cards
        if torch.cuda.device_count() >= 2:
            ranks = spawn(dp_sgd_rank, 2, backend="nccl",
                          devices=["cuda:0", "cuda:1"], args=((1, 4), seed, B),
                          workdir=root, timeout_s=DP_TIMEOUT_S)
            check_dp_sgd("(e) NCCL, 2 cards", ranks, (1, 4), B, card)
        else:
            log(f"[dp] (e) NCCL over two cards: not run, this machine has "
                f"{torch.cuda.device_count()} card")
    log(f"[dp] phase 11 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


# --------------------------------------------------------------- phase 12

NORM_FRAMES = 30    # a served clip's frames through the refine CRN
NORM_TRAIN_FRAMES = 4   # a stage-4 step's frames through the refine CRN
NORM_CALLS = 26     # SampleLayerNorm calls of one CRNSmaller forward
# gradients against autograd of the plain form, relative L2 (bfloat16;
# tests/test_torch_port_norm_cuda.py states why)
NORM_DX_RTOL = 1e-2
NORM_PARAM_RTOL = 1e-3


def crn_norm_inputs(seed: int, fg: bool, T: int, S: int,
                    grad: bool = False) -> list:
    """The inputs of the 26 ``SampleLayerNorm`` calls of one ``CRNSmaller``
    forward (``fg``: the refine CRN, else the background's) over ``T``
    images at ``S``², bfloat16, on a channels-last label as the generator
    hands it over, with gamma and beta; ``grad``: the forward under
    autograd, as training runs it. A traced forward must leave 26
    ``nets.norm`` spans."""
    from jafpro_tpu_torch.models import common
    from jafpro_tpu_torch.models.crn import CRNSmaller
    from jafpro_tpu_torch.utils import profiling

    net = CRNSmaller(fg=fg, compute_dtype=torch.bfloat16)
    common.init_params_(net, torch.Generator().manual_seed(seed))
    net.to("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    label = torch.rand(T, S, S, 3, generator=g, device="cuda").permute(
        0, 3, 1, 2)
    seen = []

    def keep(module, args):
        seen.append((args[0].detach().clone(), module.gamma.detach(),
                     module.beta.detach()))

    hooks = [m.register_forward_pre_hook(keep) for m in net.modules()
             if isinstance(m, common.SampleLayerNorm)]
    with torch.set_grad_enabled(grad):
        net(label, S)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        t0 = time.time_ns()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            net(label, S)
            torch.cuda.synchronize()
            names = [r["name"] for r in profiling.spans(t0)]
    n_spans = names.count("nets.norm")
    log(f"[norm] a traced {'refine' if fg else 'background'} CRN forward "
        f"over {T} images: {n_spans} nets.norm spans")
    if n_spans != NORM_CALLS or len(seen) != NORM_CALLS:
        raise AssertionError("not every SampleLayerNorm call of the CRN "
                             "took the kernels")
    return seen


def norm_forward_ulp(calls: list) -> tuple:
    """The kernels against the plain form on ``calls``: the worst distance
    in bfloat16 ulps (values under 1/64 taken at 1/64) of the rounded
    pre-activation and of the LeakyReLU's output, and whether the kernels'
    output is ``F.leaky_relu`` of their own pre-activation bit for bit.
    One ulp of a negative pre-activation can be two of its LeakyReLU:
    0.01 · x crosses a binade where x does not."""
    import torch.nn.functional as F

    from jafpro_tpu_torch.ops import norm as N

    def ulps(got, want):
        m = want.float().abs().clamp_min(1.0 / 64)
        ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
        return ((got.float() - want.float()).abs() / ulp).max().item()

    worst_pre = worst_out = 0.0
    same = True
    for x, gamma, beta in calls:
        with torch.no_grad():
            pre = N.sample_norm(x, gamma, beta, 1, 1e-5)
            y = N.sample_norm(x, gamma, beta, 1, 1e-5, 0.01)
            want = N.sample_norm_plain(x, gamma, beta, 1, 1e-5)
            worst_pre = max(worst_pre, ulps(pre, want))
            worst_out = max(worst_out, ulps(y, F.leaky_relu(want, 0.01)))
            same = same and torch.equal(y, F.leaky_relu(pre, 0.01))
    return worst_pre, worst_out, same


def norm_backward_check(seed: int, calls: list) -> dict:
    """Forward and backward of each call through the kernels against
    autograd of the plain form, an incoming bfloat16 gradient drawn from
    ``seed`` (zero where the plain form's pre-activation lies within 1e-3
    of 0, as the card test has it): the worst relative L2 of dx, dgamma,
    dbeta."""
    from jafpro_tpu_torch.ops import norm as N

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"dx": 0.0, "dgamma": 0.0, "dbeta": 0.0}
    for x, gamma, beta in calls:
        with torch.no_grad():
            pre = N.sample_norm_plain(x, gamma, beta, 1, 1e-5)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
        dy = torch.where(pre.float().abs() < 1e-3, torch.zeros_like(dy), dy)
        del pre
        got, want = [], []
        for fn, out in ((N.sample_norm, got), (N.sample_norm_plain, want)):
            xa, ga, ba = (t.detach().clone().requires_grad_()
                          for t in (x, gamma, beta))
            fn(xa, ga, ba, 1, 1e-5, 0.01).backward(dy)
            out.extend((xa.grad, ga.grad, ba.grad))
        for k, a, b in zip(worst, got, want):
            worst[k] = max(worst[k], rel_l2(a, b))
    return worst


def phase_norm(seed: int, card: str) -> dict:
    """Phase 12. Returns the norm kernels' JSON record."""
    from jafpro_tpu_torch.ops import norm as N

    t_phase = time.perf_counter()
    T, S = NORM_FRAMES, 256
    calls = crn_norm_inputs(seed, True, T, S)
    bg = crn_norm_inputs(seed + 1, False, 1, S)
    fwd = {"refine CRN, 30 frames": norm_forward_ulp(calls),
           "background CRN, 1 image": norm_forward_ulp(bg)}
    log("[norm] against the plain form, worst bfloat16 ulp of the "
        "pre-activation / of the LeakyReLU's output, and the output the "
        "LeakyReLU of the kernels' own pre-activation bit for bit: "
        + "; ".join(f"{k} {p:.3f} / {o:.3f}, {same}"
                    for k, (p, o, same) in fwd.items()))
    worst = max(p for p, _, _ in fwd.values())
    if worst > 1.0 or not all(same for _, _, same in fwd.values()):
        raise AssertionError("the norm kernels are further than one ulp "
                             "from the plain form")
    layouts = sum(not x.is_contiguous() for x, _, _ in calls)
    elems = sum(x.numel() for x, _, _ in calls)
    bound_ms = 1e3 * sum(2 * x.numel() * x.element_size()
                         for x, _, _ in calls) / PEAK_BYTES_PER_S

    def kernels():
        for x, gamma, beta in calls:
            N.sample_norm(x, gamma, beta, 1, 1e-5, 0.01)

    def plain():
        for x, gamma, beta in calls:
            N.sample_norm_plain(x, gamma, beta, 1, 1e-5, 0.01)

    with torch.no_grad():
        ms = median_cuda_ms(kernels)
        plain_ms = median_cuda_ms(plain, 3, 1)
    log(f"[norm] one clip's refine CRN ({T} frames, {len(calls)} calls, "
        f"{layouts} channels-last, {elems / 1e9:.3f} G elements, "
        f"bfloat16): kernels {ms:.3f} ms, plain {plain_ms:.3f} ms, bytes "
        f"bound {bound_ms:.3f} ms (share {bound_ms / ms:.3f}) [{card}]")
    del calls, bg
    torch.cuda.empty_cache()

    Tt = NORM_TRAIN_FRAMES
    train = crn_norm_inputs(seed + 2, True, Tt, S, grad=True)
    bwd = norm_backward_check(seed + 3, train)
    log(f"[norm] a stage-4 step's refine CRN ({Tt} frames, {len(train)} "
        f"calls, {sum(not x.is_contiguous() for x, _, _ in train)} "
        f"channels-last, bfloat16), forward and backward against autograd "
        f"of the plain form, worst relative L2: dx {bwd['dx']:.3e} "
        f"(tolerance {NORM_DX_RTOL}), dgamma {bwd['dgamma']:.3e}, dbeta "
        f"{bwd['dbeta']:.3e} (tolerance {NORM_PARAM_RTOL})")
    if not (bwd["dx"] <= NORM_DX_RTOL and max(
            bwd["dgamma"], bwd["dbeta"]) <= NORM_PARAM_RTOL):
        raise AssertionError("the norm's backward kernels disagree with "
                             "autograd of the plain form")
    log(f"[norm] phase 12 took {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return {"name": "sample_norm", "route": "cuda", "source": NORM_SOURCE,
            "replaces": None, "max_ulp": worst,
            "max_ulp_out": max(o for _, o, _ in fwd.values()),
            "bwd_rel_l2": bwd, "ms_per_clip": ms,
            "plain_ms_per_clip": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    card = phase_environment()
    build_s = phase_build()

    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.geometry import rasterizer as R
    from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
    from jafpro_tpu_torch.infer import VideoGenerator
    from jafpro_tpu_torch.ops import norm as N
    from jafpro_tpu_torch.pipeline import JAFProPipeline

    dev = torch.device("cuda")
    cfg = Config(compute_dtype="float32")
    T, NR, S, p, P = cfg.num_frames, cfg.maximum_ref_frames, \
        cfg.image_size, cfg.part_size, cfg.num_parts

    # ---- phase 3: kernel vs plain version ----
    clip, faces = make_clip(args.seed, T, NR, S, p, P)
    if faces.shape != (cfg.num_faces, 3) or clip["verts"].shape[1] != (
            cfg.num_verts):
        raise AssertionError("the clip mesh does not have SMPL's counts")
    engine = SMPLFlowEngine(faces=faces, image_size=S)
    k = phase_kernel(args.seed, clip, faces, S, dev, card)

    # ---- phase 4: small clip, card vs CPU ----
    phase_reference(args.seed)

    # ---- phase 5: the slice at full width ----
    pipe = JAFProPipeline(cfg, flow_engine=engine, device="cuda",
                          generator=torch.Generator().manual_seed(args.seed))
    gen = VideoGenerator(pipe, frame_batch=T, flow_mode="batch")
    torch.cuda.reset_peak_memory_stats()
    R.rasterize_fim_wim.launches = 0
    N.sample_norm.launches = N.sample_norm.backward_launches = 0
    out = gen(clip)
    torch.cuda.synchronize()
    launches = R.rasterize_fim_wim.launches
    norm_launches = N.sample_norm.launches
    log(f"[slice] main path: rasterize_fim_wim launches {launches}; "
        f"sample_norm kernel launches {norm_launches}")
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
    if norm_launches != 2 * 2 * NORM_CALLS:
        raise AssertionError("a clip's two CRNs did not take the norm "
                             "kernels in every call")
    check_outputs(out, T, S, "full-width clip")
    run_clip(gen, clip, T, S, "float32", card)
    per_frame = VideoGenerator(pipe)(clip)   # frame_batch 1, flow per frame
    d = max_diff(out, per_frame)
    log(f"[slice] per-frame schedule vs batched: max abs {d:.3e}")
    if not d <= 1e-3:
        raise AssertionError("the output depends on frame_batch/flow_mode")
    stage_breakdown(gen, clip, card)
    del pipe, gen, per_frame

    # the Config default compute dtype (bfloat16), same seeded weights
    torch.cuda.reset_peak_memory_stats()
    pipe16 = JAFProPipeline(Config(), flow_engine=engine, device="cuda",
                            generator=torch.Generator().manual_seed(args.seed))
    out16, _ = run_clip(VideoGenerator(pipe16, frame_batch=T,
                                       flow_mode="batch"), clip, T, S,
                        "bfloat16", card)
    log(f"[slice] bfloat16 vs float32: max abs {max_diff(out, out16):.3e}")
    del pipe16

    # ---- phase 6: serve and score ----
    alone = phase_serve(args.seed, engine, card)

    # ---- phase 7: train ----
    train_launches, norm_train = phase_train(args.seed, clip, engine, card)

    # ---- phase 8: the body path ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    body_launches = phase_body(args.seed, card)

    # ---- phase 9: the flow path ----
    flow_kernels = phase_flow(args.seed, card)

    # ---- phase 10: the ablation zoo ----
    phase_zoo(args.seed, card)

    # ---- phase 11: data parallelism ----
    dp_launches = phase_dp(args.seed, clip, faces, alone, card)

    # ---- phase 12: the ConvBlock norm ----
    norm_kernel = phase_norm(args.seed, card)

    kernels = [{
        "name": "rasterize_fim_wim", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "train_launches": train_launches,
        "body_launches": body_launches, "dp_launches": dp_launches,
        **k}] + flow_kernels + [{
        **norm_kernel, "launches": norm_launches,
        "train_launches": norm_train[0],
        "train_backward_launches": norm_train[1]}]
    log(f"[done] build {build_s:.2f} s, total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
