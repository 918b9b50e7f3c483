#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``jafpro_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (nothing is caught):

1. Environment: torch/CUDA versions, ``nvcc --version``, the card's name
   and power limit; needs one Hopper card (compute capability 9.0).
2. Build: compile ``jafpro_tpu_torch/csrc/rasterizer.cu`` with nvcc.
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

Prints the kernels' JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
PEAK_BYTES_PER_S = 3.35e12
OPS_PER_PAIR = 40  # fp32 operations per (pixel, face) test in the kernel
KERNEL_SOURCE = "jafpro_tpu_torch/csrc/rasterizer.cu"
KERNEL_REPLACES = "jafpro_tpu/geometry/rasterizer_pallas.py:119"
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
    from jafpro_tpu_torch import cuda_build

    path, secs, out = cuda_build.build("rasterizer.cu")
    for line in out.strip().splitlines():
        log(f"[build] {line}")
    log(f"[build] {path} in {secs:.2f} s")
    cuda_build.load("rasterizer.cu")
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
    from jafpro_tpu_torch.geometry import rasterizer as R

    prep = R.prepare_faces(face_verts, S)
    fim, wim = R.rasterize_prepared_cuda(prep, S, 0.1, 25.0)
    rfim, rwim = R.rasterize_prepared_reference(prep, S, 0.1, 25.0)
    torch.cuda.synchronize()
    mismatch = int((fim != rfim).sum().item())
    werr = float((wim - rwim).abs().max().item())
    cover = float((fim >= 0).float().mean().item())
    log(f"[kernel] {what}: B={face_verts.shape[0]} F={face_verts.shape[1]} "
        f"S={S} fim_mismatch={mismatch} wim_max_abs={werr:.3e} "
        f"coverage={cover:.3f}")
    if mismatch or not werr <= 1e-5:
        raise AssertionError(f"kernel disagrees with plain version ({what})")
    if cover <= 0.01:
        raise AssertionError(f"scene {what} covers no pixels")
    return {"prep": prep, "fim": fim, "fim_mismatch": mismatch,
            "wim_max_abs": werr}


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
    log(f"[kernel] clip: kernel {kernel_ms:.4f} ms (shuffled face order "
        f"{kernel_shuf_ms:.4f} ms), wrapper (prep+kernel) "
        f"{wrapper_ms:.4f} ms, plain {plain_ms:.2f} ms per 30-pose clip; "
        f"bbox pairs {pairs} of dense {dense_pairs} "
        f"({pairs / dense_pairs:.5f}); bound {bound_ms:.5f} ms "
        f"({'operations' if ops_s >= bytes_s else 'bytes'}) [{card}]")
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
        st = cli.serve(groups, load, cli.generate_group(gen), write)
        launches = R.rasterize_fim_wim.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[serve] {what} {run} loop: {len(vids)} clips in {len(groups)} "
            f"batches of {clips_per_batch}: "
            f"{len(vids) / st['loop_seconds']:.3f} clips/s "
            f"({st['loop_seconds']:.4f} s); per batch load "
            f"{st['load_ms']:.2f} ms, compute {st['compute_ms']:.2f} ms, "
            f"write {st['write_ms']:.2f} ms; rasterize_fim_wim launches "
            f"{launches}; peak memory {peak:.2f} GiB [{card}]")
        if launches != len(groups):
            raise AssertionError("a batch did not rasterize in one launch")
    for vid in vids:
        for k, c in (("final", 3), ("coarse", 3), ("mask", 1), ("tsf", 3)):
            x = written[vid][k]
            if x.dtype != np.uint8 or x.shape != (
                    cfg.num_frames, cfg.image_size, cfg.image_size, c):
                raise AssertionError(f"served {vid}: {k} {x.dtype} {x.shape}")
    return vids, load, gen, written


def phase_serve(seed: int, engine, card: str) -> None:
    """Phase 6: pack four clips, serve them in two batches through the
    CLI's loop (float32, then the CLI's default bfloat16), check the
    batches against per-clip generation, and score two of them."""
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
        d = max(u8_diff(served[vid], gen(clip))
                for vid, clip in zip(vids, clips))
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
        served16 = serve_pack(Config(), engine, seed, pack_dir, per_batch,
                              "bfloat16", card)[3]
        log(f"[serve] bfloat16 vs float32 served: max "
            f"{max(u8_diff(served16[v], served[v]) for v in vids)} LSB")
        del served16

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
    out = gen(clip)
    torch.cuda.synchronize()
    launches = R.rasterize_fim_wim.launches
    log(f"[slice] main path: rasterize_fim_wim launches {launches}")
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
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
    phase_serve(args.seed, engine, card)

    kernels = [{
        "name": "rasterize_fim_wim", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, **k}]
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
