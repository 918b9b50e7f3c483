"""Command-line entry points of the port (``python -m jafpro_tpu_torch.cli``).

``train --stage N -n <exp>`` trains stage N (1-4) from packed shards
(``--shards``), synthetic batches (``--synthetic``) or per-sample dataset
loads, and saves ``.npz`` checkpoints that ``infer`` serves; ``infer -e
<exp> -n <num_refs>`` serves the test clips (decoded from the dataset or
read from a pack) and writes their frames; ``evaluate --pred <dir> --gt
<dir>`` scores them; ``gif`` stacks frames into GIFs; ``pack --kind
interval|textonly|clips`` packs training records or serving clips. The
commands mirror ``jafpro_tpu/cli.py``'s; ``train``, ``infer`` and
``evaluate`` run on ``--device``, ``cuda`` unless asked otherwise. Frames
are read and written with ``cv2``, imported where it is used.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from jafpro_tpu_torch.config import default_smpl_faces_path, get_general_options
from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.utils import profiling

STREAMS = ("final", "coarse", "mask", "tsf")
_PREFIX = {"final": "frame", "coarse": "coarse_frame", "mask": "mask_frame",
           "tsf": "tsf_frame"}


def serve(items: Sequence[Any], load: Callable, compute: Callable,
          write: Callable, prefetch: int = 2, writers: int = 2) -> dict:
    """The serving loop: for each item ``write(item, compute(item,
    load(item)))`` over ``run_overlapped`` (loads prefetched, writes in a
    pool, compute on this thread in order), each phase in its span
    (``serve.load``, ``serve.compute``, ``serve.write``; the item is the
    served group). Returns the loop's wall seconds and each phase's mean
    milliseconds per item, from those spans (the phases overlap, so these
    are occupancy times, not a serial sum)."""
    from jafpro_tpu_torch.utils.overlap import run_overlapped

    phases: Dict[str, list] = {"load": [], "compute": [], "write": []}

    def phase(name, fn):
        kept, full = phases[name], "serve." + name

        def wrap(item, *a):
            with profiling.span(full, item=item, keep=kept):
                return fn(item, *a)
        return wrap

    t0 = time.perf_counter()
    n = 0
    for _ in run_overlapped(items, phase("load", load),
                            phase("compute", compute), phase("write", write),
                            prefetch=prefetch, writers=writers):
        n += 1
    stats = {"items": n, "loop_seconds": time.perf_counter() - t0}
    for k, v in phases.items():
        stats[f"{k}_ms"] = sum(s.host_ms for s in v) / len(v) if v else 0.0
    return stats


def open_clip_source(cfg, num_refs: int, packed_clips: str = "",
                     audit_path: Optional[str] = None):
    """(video names, ``load(group) -> [clip, ...]``) for the serving loop,
    reading a pack (``pack --kind clips``) or decoding the dataset's test
    clips. A pack whose clips hold another number of references than
    ``num_refs`` is refused. Each loaded clip appends its audit line (the
    chosen reference frames) to ``audit_path`` when one is given."""
    from jafpro_tpu_torch.data.dataset import list_videos, load_clip

    reader = None
    if packed_clips:
        from jafpro_tpu_torch.data.shardio import ClipPackReader

        reader = ClipPackReader(packed_clips)
        if reader.num_refs != num_refs:
            raise SystemExit(
                f"infer: the pack {packed_clips} holds clips with "
                f"{reader.num_refs} references but -n {num_refs} was asked; "
                f"pass -n {reader.num_refs}, or repack with `python -m "
                f"jafpro_tpu_torch.cli pack --kind clips --mode test "
                f"--num_refs {num_refs} --out <dir>`")
        vids = list(reader.vids)
        index = {v: i for i, v in enumerate(vids)}
    else:
        vids = list_videos(cfg.data_root, "test")
    audit_lock = threading.Lock()

    def load_one(vid):
        if reader is not None:
            clip = reader.load(index[vid])
        else:
            clip = load_clip(
                os.path.join(cfg.data_root, "test"),
                os.path.join(cfg.smpl_root, "test"),
                os.path.join(cfg.mask_root, "test"),
                vid, num_refs=num_refs)
        if audit_path is not None:
            msg = "the chosen frame index of video %s is" % vid
            msg += "".join(",%s" % n for n in clip["chosen_names"])
            with audit_lock, open(audit_path, "a") as f:
                f.write("%s.\n\n" % msg)
        return clip

    def load(group):
        return [load_one(v) for v in group]

    return vids, load


def generate_group(gen) -> Callable:
    """``compute(group, clips)`` for the serving loop: the group's clips as
    one ``generate_batch`` call, waited for on the card (``serve.sync``: the
    host's wait), so the compute phase's time is the batch's (the writer
    copies the frames out)."""
    from jafpro_tpu_torch.infer import stack_clips

    def compute(group, clips):
        out = gen.generate_batch(stack_clips(clips))
        with profiling.span("serve.sync"):
            if gen.pipe.device.type == "cuda":
                torch.cuda.synchronize(gen.pipe.device)
        return out

    return compute


def serving_generator(pipe, cfg):
    """The generator ``infer`` serves with: a clip's frames in one group,
    the flow branch batched, outputs encoded to uint8 on the card."""
    from jafpro_tpu_torch.infer import VideoGenerator

    return VideoGenerator(pipe, frame_batch=cfg.num_frames,
                          flow_mode="batch", output_uint8=True)


def fetch_clips(group: Sequence[str], out: dict,
                streams) -> Dict[str, Dict[str, np.ndarray]]:
    """The writer's copy of a batch to the host: ``{vid: {stream: (T, S,
    S, C) uint8}}`` for each of ``streams`` (``serve.fetch``, ``n`` the
    bytes copied)."""
    from jafpro_tpu_torch.infer import frames_to_uint8

    with profiling.span("serve.fetch") as sp:
        if sp:
            sp.n = sum(out[s].nbytes for s in streams)
        host = {s: out[s].cpu() for s in streams}
        return {vid: {s: frames_to_uint8(host[s][ci]) for s in streams}
                for ci, vid in enumerate(group)}


def group_items(vids: Sequence[str], size: int) -> List[tuple]:
    return [tuple(vids[i:i + size]) for i in range(0, len(vids), size)]


def _parse_streams(spec: str) -> frozenset:
    streams = frozenset(s for s in spec.split(",") if s)
    if streams - set(STREAMS) or "final" not in streams:
        raise SystemExit(f"--streams must include 'final' and only "
                         f"final/coarse/mask/tsf (got {spec!r})")
    return streams


def build_pipeline(cfg, device, generator=None):
    """The pipeline on SMPL's faces (``default_smpl_faces_path``);
    refuses to run without them."""
    from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
    from jafpro_tpu_torch.pipeline import JAFProPipeline

    path = default_smpl_faces_path()
    if path is None:
        raise SystemExit(
            "SMPL faces not found; set JAFPRO_SMPL_FACES to an .npy "
            "of SMPL's (13776, 3) face indices (the repository ships none)")
    engine = SMPLFlowEngine.create(
        faces=np.load(path), image_size=cfg.image_size, near=cfg.near,
        far=cfg.far, viewing_angle=cfg.viewing_angle)
    return JAFProPipeline(cfg, flow_engine=engine, device=device,
                          generator=generator)


# Cross-stage warm start: the modules each stage takes from the previous
# stage's weights (fresh optimizer state, as the reference's
# load_state_dict-then-new-Adam start-ups):
#   stage 2 loads accu          (train/2.text_inpaint_convLSTM.py:79-85)
#   stage 3 loads accu+inpaint  (train/3.inpaint_global_convLSTM_FGAN.py:123-129)
#   stage 4 loads accu+inpaint+bg+refine (train/4...py:120-141)
STAGE_WARM_MODULES = {
    2: ("accu",),
    3: ("accu", "inpaint"),
    4: ("accu", "inpaint", "bg", "refine"),
}


def _warm_start(pipe, cfg, stage: int, init_from: str) -> None:
    """Load the stage's consumed modules from a donor experiment's ``.npz``
    (``--init-from <exp>[:<step>]``, its newest when no step is given)."""
    from jafpro_tpu_torch.bridge import load_flax
    from jafpro_tpu_torch.checkpoints import (
        export_name, latest_export, load_params_npz)

    if stage not in STAGE_WARM_MODULES:
        raise SystemExit(
            "--init-from applies to stages 2-4 (stage 1 trains from scratch "
            "in the reference)")
    donor, _, step_s = init_from.partition(":")
    donor_dir = os.path.join(cfg.model_save_dir, donor)
    if step_s:
        path = os.path.join(donor_dir, export_name(int(step_s)))
        if not os.path.exists(path):
            raise SystemExit(f"--init-from: no {path}")
    else:
        found = latest_export(donor_dir)
        if found is None:
            raise SystemExit(f"--init-from: no checkpoints under {donor_dir}")
        path = found[1]
    donor_params = load_params_npz(path)
    mods = STAGE_WARM_MODULES[stage]
    for m in mods:
        if m not in donor_params:
            raise SystemExit(
                f"--init-from: donor checkpoint lacks module {m!r} "
                f"(has {sorted(donor_params)})")
        load_flax(getattr(pipe, m), donor_params[m])
    print(f"warm start: {{{','.join(mods)}}} <- {path}")


def make_step(pipe, stage: int):
    """(step function, lrs) of training stage ``stage``."""
    if stage == 1:
        from jafpro_tpu_torch.train.stage1 import make_stage1_step, stage1_lrs
        return make_stage1_step(pipe), stage1_lrs()
    if stage == 2:
        from jafpro_tpu_torch.train.stage2 import make_stage2_step, stage2_lrs
        return make_stage2_step(pipe), stage2_lrs()
    from jafpro_tpu_torch.train import stage34
    if stage == 3:
        return stage34.make_stage3_step(pipe), stage34.stage3_lrs()
    return stage34.make_stage4_step(pipe), stage34.stage4_lrs()


def _shard_paths(shards: str) -> list:
    import glob

    if os.path.isdir(shards):
        paths = sorted(glob.glob(os.path.join(shards, "*.shard")))
    else:
        paths = sorted(glob.glob(shards))
    if not paths:
        raise FileNotFoundError(f"no .shard files match {shards}")
    return paths


def _raw_batch_source(args, cfg, rng, verts, in_order: bool = False):
    """(next_raw, close): ``next_raw()`` gives a stacked raw batch (before
    the curriculum) from --shards (the native reader), --synthetic, or
    per-sample dataset loads; ``close()`` releases the source. With
    ``in_order`` the reader uses one thread, so its batches come in the
    seed's order (every rank of a mesh draws the same ones)."""
    from jafpro_tpu_torch.train.common import synthetic_batch

    if args.shards:
        from jafpro_tpu_torch.data.shardio import (
            ShardReader, collapse_target_dims, stage_spec)

        spec = stage_spec(
            args.stage, num_refs=cfg.maximum_ref_frames,
            num_target=cfg.num_target, image_size=cfg.image_size,
            part_size=cfg.part_size, num_parts=cfg.num_parts,
            num_verts=verts.shape[0] if verts is not None else cfg.num_verts)
        reader = ShardReader(
            spec, _shard_paths(args.shards), batch=cfg.batch_size,
            prefetch=4, threads=1 if in_order else 2, seed=args.seed,
            shuffle=True, loop=True)
        print(f"shard reader: {reader.num_records} records")
        return (lambda: collapse_target_dims(spec, next(reader))), \
            reader.close

    if args.synthetic:
        def synth():
            b = synthetic_batch(
                rng, batch=cfg.batch_size, num_refs=cfg.maximum_ref_frames,
                part_size=cfg.part_size, image_size=cfg.image_size,
                num_verts=verts.shape[0])
            b["prev_verts"] = np.tile(verts[None], (cfg.batch_size, 1, 1))
            b["tgt_verts"] = b["prev_verts"] + np.float32([0.02, 0, 0])
            return b
        return synth, lambda: None

    from jafpro_tpu_torch.data.dataset import (
        list_videos, load_interval_sample, load_textonly_sample)

    vids = list_videos(cfg.data_root, "train")
    if not vids:
        raise FileNotFoundError(
            f"no training videos under {cfg.data_root}/train "
            "(set JAFPRO_DATA_ROOT, pass --shards, or use --synthetic)")

    def load():
        samples = []
        for _ in range(cfg.batch_size):
            vid = vids[rng.randint(len(vids))]
            if args.stage <= 2:
                s = load_textonly_sample(
                    os.path.join(cfg.data_root, "train"), vid, rng,
                    cfg.maximum_ref_frames, cfg.num_target,
                    fix_frame=cfg.fix_frame, self_recon=cfg.self_recon)
            else:
                s = load_interval_sample(
                    os.path.join(cfg.data_root, "train"),
                    os.path.join(cfg.smpl_root, "train"),
                    os.path.join(cfg.mask_root, "train"),
                    vid, rng, cfg.maximum_ref_frames, 1)
                for k in ("src_imgs", "src_cams", "src_verts",
                          "src_frame_indices"):
                    s[k] = s[k][None]  # align to the (B, R, ...) layout
            samples.append(s)
        return {k: np.concatenate([s[k] for s in samples])
                for k in samples[0]}
    return load, lambda: None


def _rank_devices(cmd: str, device: str, n: int) -> tuple:
    """(backend, each rank's device) for ``n`` ranks on ``device``'s kind:
    NCCL with one card per rank on CUDA, gloo on the CPU. Refuses more
    ranks than cards: ranks never share a card, and nothing falls back to
    gloo or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise SystemExit(
                f"{cmd}: --num-devices {n} needs {n} CUDA devices, this "
                f"host has {count}; the ranks take one card each")
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", [str(dev)] * n


@contextlib.contextmanager
def _quiet_unless_main(mesh):
    """Rank 0 prints; the other ranks' standard output is dropped."""
    if mesh.rank == 0:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def train_config(args):
    """The training ``Config`` for ``args``: the general options with the
    command line's overrides (the synthetic size, dtype, batch, face GAN,
    save interval)."""
    cfg = get_general_options()
    if args.synthetic:  # the JAX CLI's small synthetic configuration
        cfg.image_size = 64
        cfg.part_size = 16
        cfg.face_crop_size = 16
        cfg.compute_dtype = "float32"
        cfg.maximum_ref_frames = 2
    if args.no_face_gan:
        cfg.face_GAN = False  # reference flag (options.py; train/4:357-374)
    if args.dtype:
        cfg.compute_dtype = args.dtype
    if args.batch_size:
        cfg.batch_size = args.batch_size
    elif args.stage == 2:
        # the reference's stage-2 schedule trains batch 2 (train/2:64)
        cfg.batch_size = 2
    if args.debug:
        cfg.model_save_interval = 3
        cfg.vis_interval = 3
    return cfg


def cmd_train(args) -> None:
    cfg = train_config(args)
    n = args.num_devices
    if n <= 1:
        run_train(args, cfg)
        return
    from jafpro_tpu_torch.parallel import spawn

    if cfg.batch_size % n:
        raise SystemExit(f"batch_size {cfg.batch_size} not divisible by "
                         f"--num-devices {n}")
    backend, devices = _rank_devices("train", args.device, n)
    print(f"data-parallel over {n} devices", flush=True)
    spawn(_train_rank, n, backend=backend, devices=devices,
          args=(args, cfg))


def _train_rank(mesh, args, cfg) -> None:
    with _quiet_unless_main(mesh):
        run_train(args, cfg, mesh)


@contextlib.contextmanager
def traced(trace_dir: str, mesh=None):
    """With ``trace_dir`` (``--trace-dir``), the block runs inside
    ``profiling.trace(trace_dir)`` (a mesh's rank ``r`` in
    ``trace_dir/rank<r>``), and the spans it recorded are written to
    ``spans.jsonl`` there, one JSON record per span (a count of those the
    full buffer dropped is printed)."""
    if not trace_dir:
        yield
        return
    if mesh is not None:
        trace_dir = os.path.join(trace_dir, f"rank{mesh.rank}")
    t0, dropped = time.time_ns(), profiling.dropped()
    with profiling.trace(trace_dir):
        yield
    path = os.path.join(trace_dir, "spans.jsonl")
    with open(path, "w") as f:     # an item that is no JSON value: its str
        for r in profiling.spans(t0):
            f.write(json.dumps(r, default=str) + "\n")
    if profiling.dropped() > dropped:
        print(f"{path}: {profiling.dropped() - dropped} spans dropped "
              f"(the buffer holds {profiling.MAX_SPANS})")


def run_train(args, cfg, mesh=None) -> None:
    """``cli train`` on one device, or as one rank of ``mesh``: every rank
    builds the same seeded pipeline (made rank 0's by ``replicate``) and
    draws the same global batches, keeps its ``shard_batch`` of each and
    steps through ``data_parallel_jit``; rank 0 alone logs and saves."""
    import queue

    from jafpro_tpu_torch.checkpoints import (
        restore_train_state, save_checkpoint)
    from jafpro_tpu_torch.pipeline import JAFProPipeline
    from jafpro_tpu_torch.train.common import (
        TrainState, apply_curriculum, synthetic_quad_mesh, to_device)

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    main_rank = mesh is None or mesh.rank == 0
    gen = torch.Generator().manual_seed(args.seed)
    verts = None
    if args.synthetic:
        from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine

        verts, faces = synthetic_quad_mesh(6)
        pipe = JAFProPipeline(
            cfg, flow_engine=SMPLFlowEngine.create(
                faces=faces, image_size=cfg.image_size),
            device=dev, generator=gen)
    elif args.stage == 4:
        pipe = build_pipeline(cfg, dev, gen)
    else:  # stages 1-3 do not rasterize
        pipe = JAFProPipeline(cfg, device=dev, generator=gen)
    if args.init_from:
        _warm_start(pipe, cfg, args.stage, args.init_from)
    step_fn, lrs = make_step(pipe, args.stage)
    state = TrainState(pipe, lrs)

    ckpt_dir = os.path.join(cfg.model_save_dir, args.exp_name)
    start_it = 0
    if args.resume:  # every rank reads the same save
        try:
            prev = restore_train_state(pipe, state, ckpt_dir)
        except FileNotFoundError as e:
            raise SystemExit(f"train --resume: {e}")
        if prev is not None:
            start_it = prev + 1
            print(f"resumed from {ckpt_dir}/params_iter_{prev}.npz")
    if mesh is not None:
        from jafpro_tpu_torch.parallel import (
            data_parallel_jit, replicate, shard_batch)

        replicate(mesh, pipe)
        step_fn = data_parallel_jit(step_fn, mesh)
    if main_rank:
        os.makedirs(ckpt_dir, exist_ok=True)

    rng = np.random.RandomState(args.seed + start_it)
    next_raw, close_source = _raw_batch_source(args, cfg, rng, verts,
                                               in_order=mesh is not None)
    # one feeder thread reads, applies the curriculum and copies batch i+1
    # (this rank's shard of it) to the device while step i runs; one
    # worker keeps the rng draws in the serial loop's order
    batch_q: "queue.Queue" = queue.Queue(maxsize=2)

    def feed():
        try:
            for _ in range(args.iters):
                b = apply_curriculum(dict(next_raw()), args.stage, rng,
                                     cfg.maximum_ref_frames)
                batch_q.put(to_device(b, dev) if mesh is None
                            else shard_batch(mesh, b))
            batch_q.put(None)
        except BaseException as e:  # re-raised by the training loop
            batch_q.put(e)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    # every step's metrics (G/D/FD/recon/...), one JSON line per step
    with (open(os.path.join(ckpt_dir, "losses.jsonl"),
               "a" if start_it else "w") if main_rank
          else contextlib.nullcontext()) as loss_log, \
            traced(args.trace_dir, mesh):
        for it in range(start_it, start_it + args.iters):
            batch = batch_q.get()
            if isinstance(batch, BaseException):
                raise batch
            with profiling.step_timer(
                    sync=dev if dev.type == "cuda" else False) as timer:
                state, metrics = step_fn(state, batch)
            seconds = timer["seconds"]
            row = {"stage": args.stage, "iter": it,
                   "seconds": round(seconds, 4)}
            row.update({k: float(v) for k, v in metrics.items()})
            if main_rank:
                loss_log.write(json.dumps(row) + "\n")
            print(f"[stage{args.stage}] iter {it} loss {row['loss']:.4f} "
                  f"({seconds:.3f}s)")
            if it > 0 and it % cfg.model_save_interval == 0:
                save_checkpoint(ckpt_dir, it, pipe, state, mesh)
    # the feeder has read its last batch; the reader may close only once
    # no thread is inside it
    feeder.join()
    close_source()
    last = start_it + args.iters - 1
    save_checkpoint(ckpt_dir, max(last, 0), pipe, state, mesh)
    print("Training Done.")


def serve_share(groups: Sequence[tuple], load: Callable, compute: Callable,
                write: Callable, mesh=None, **kw) -> dict:
    """``serve`` over this rank's share of ``groups`` (round-robin: rank r
    takes groups r, r + world, ...; all of them without a mesh). Returns
    the loop's stats with ``clips`` counted; with a mesh, every rank's:
    the clips summed, the slowest rank's loop seconds and each phase's
    milliseconds averaged over the batches of all ranks."""
    mine = list(groups)
    if mesh is not None:
        mine = mine[mesh.rank::mesh.world]
    stats = serve(mine, load, compute, write, **kw)
    stats["clips"] = sum(len(g) for g in mine)
    if mesh is None:
        return stats
    from jafpro_tpu_torch.parallel.mesh import gather_over_ranks

    keys = ("clips", "items", "loop_seconds", "load_ms", "compute_ms",
            "write_ms")
    per = gather_over_ranks(torch.tensor(
        [float(stats[k]) for k in keys], dtype=torch.float64), mesh).cpu()
    per = {k: per[:, i] for i, k in enumerate(keys)}
    items = max(float(per["items"].sum()), 1.0)
    out = {"clips": int(per["clips"].sum()), "items": int(per["items"].sum()),
           "loop_seconds": float(per["loop_seconds"].max()),
           "ranks": mesh.world}
    for k in ("load_ms", "compute_ms", "write_ms"):
        out[k] = float((per[k] * per["items"]).sum()) / items
    return out


def cmd_infer(args) -> None:
    _parse_streams(args.streams)
    if args.clips_per_batch < 1:
        raise SystemExit("infer: --clips-per-batch must be >= 1")
    cfg = get_general_options()
    n = args.num_devices
    if n <= 1:
        run_infer(args, cfg)
        return
    from jafpro_tpu_torch.parallel import spawn

    backend, devices = _rank_devices("infer", args.device, n)
    print(f"data-parallel over {n} devices", flush=True)
    spawn(_infer_rank, n, backend=backend, devices=devices, args=(args, cfg))


def _infer_rank(mesh, args, cfg) -> None:
    with _quiet_unless_main(mesh):
        run_infer(args, cfg, mesh)


def run_infer(args, cfg, mesh=None) -> None:
    """``cli infer`` on one device, or as one rank of ``mesh``: each rank
    loads, generates and writes its share of the clip groups
    (``serve_share``); rank 0 writes ``serving_stats.json`` for all."""
    from jafpro_tpu_torch.checkpoints import restore_latest

    streams = _parse_streams(args.streams)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    # the reference appends one line per video naming the chosen reference
    # frames (``src/data.py:530-535`` -> log_result/chosen_frame.txt)
    audit_dir = os.path.join(cfg.project_dir, "log_result")
    os.makedirs(audit_dir, exist_ok=True)
    vids, load = open_clip_source(
        cfg, args.num_refs, args.packed_clips,
        os.path.join(audit_dir, "chosen_frame.txt"))

    pipe = build_pipeline(cfg, dev)
    ckpt_dir = os.path.join(cfg.model_save_dir, args.exp_name)
    try:
        step = restore_latest(pipe, ckpt_dir)
    except FileNotFoundError as e:
        raise SystemExit(f"infer: {e}")
    if step is not None:
        print(f"restored {ckpt_dir}/params_iter_{step}.npz")
    else:
        print(f"no exported params in {ckpt_dir}: seeded weights")
    if mesh is not None:
        from jafpro_tpu_torch.parallel import replicate

        replicate(mesh, pipe)
    gen = serving_generator(pipe, cfg)

    def write(group, out):
        import cv2

        for vid, clip in fetch_clips(group, out, streams).items():
            save_dir = os.path.join(cfg.test_save_dir, args.exp_name, vid)
            os.makedirs(save_dir, exist_ok=True)
            for s in STREAMS:
                if s not in streams:
                    continue
                arr = clip[s]
                for i in range(arr.shape[0]):
                    cv2.imwrite(os.path.join(
                        save_dir, f"{_PREFIX[s]}_{i:03d}.jpg"), arr[i])
            print("wrote", save_dir)

    with traced(args.trace_dir, mesh):
        stats = serve_share(
            group_items(vids, args.clips_per_batch), load,
            generate_group(gen), write, mesh,
            prefetch=int(os.environ.get("JAFPRO_SERVE_PREFETCH", "2")),
            writers=int(os.environ.get("JAFPRO_SERVE_WRITERS", "2")))
    if vids and (mesh is None or mesh.rank == 0):
        # the serving loop only (no pipeline build or weight load)
        stats = {"clips_per_batch": args.clips_per_batch,
                 "device": str(dev), **stats}
        stats["clips_per_s"] = stats["clips"] / stats["loop_seconds"]
        with open(os.path.join(cfg.test_save_dir, args.exp_name,
                               "serving_stats.json"), "w") as f:
            json.dump(stats, f)
    print("Testing Done.")


def _metric_hooks(device) -> dict:
    """The VGG-perceptual and FlowNetSD flow-consistency nets for
    ``evaluate_video``, on ``device``. Weights come from converted torch
    checkpoints named by ``JAFPRO_VGG19_WEIGHTS`` /
    ``JAFPRO_FLOWNETSD_WEIGHTS`` when set, else from seeded initialisations
    (seeds 0 and 1; these differ from the JAX package's, so random-weight
    deep metrics are not comparable across the two packages)."""
    from jafpro_tpu_torch.models.common import init_params_
    from jafpro_tpu_torch.models.flownet import FlowNetSD, load_torch_flownet_sd
    from jafpro_tpu_torch.models.vgg import VGG19Features, load_torch_vgg19

    nets = {}
    for key, net, var, loader, seed in (
            ("vgg", VGG19Features(), "JAFPRO_VGG19_WEIGHTS",
             load_torch_vgg19, 0),
            ("flownet", FlowNetSD(), "JAFPRO_FLOWNETSD_WEIGHTS",
             load_torch_flownet_sd, 1)):
        path = os.environ.get(var, "")
        if path and os.path.exists(path):
            net.load_state_dict(loader(path), strict=True)
        else:
            init_params_(net, torch.Generator().manual_seed(seed))
        nets[key] = net.to(device).eval()
    return nets


def _eval_select_frames(files, data_type: str, role: str):
    """Frame-name selection + ordering for one video dir, matching the
    reference evaluator's three prediction conventions
    (``test/video_evaluation.py:104-134``):

    * gt (any type): drop text/mask/IUV/bbox files, sort by the frame
      index parsed as ``int(name[6:-4])`` (``frame_<i>.jpg``);
    * densepose pred: additionally drop coarse/tsf, same sort;
    * openpose pred: keep ``*src*``-free pngs, sort ``int(name[11:-4])``;
    * every pred: keep ``*synthesized*`` files, sort ``int(name[4:8])``.

    Falls back to a lexicographic sort when a name does not carry the
    convention's integer."""
    if role == "gt" or data_type == "densepose":
        drop = ("text", "mask", "IUV", "bbox")
        if role != "gt":
            drop += ("coarse", "tsf")
        keep = [f for f in files
                if f.endswith((".jpg", ".png"))
                and all(s not in f for s in drop)]
        key = lambda x: int(x[6:-4])  # noqa: E731
    elif data_type == "openpose":
        keep = [f for f in files if f.find("png") > 0 and "src" not in f]
        key = lambda x: int(x[11:-4])  # noqa: E731
    else:  # every
        keep = [f for f in files if "synthesized" in f]
        key = lambda x: int(x[4:8])  # noqa: E731
    try:
        return sorted(keep, key=key)
    except ValueError:
        return sorted(keep)


def cmd_evaluate(args) -> None:
    import cv2

    from jafpro_tpu_torch.evaluate import evaluate_video

    dev = resolve_device(args.device)
    hooks = {} if args.no_deep_metrics else _metric_hooks(dev)
    data_type = args.type

    def read_frames(d, role):
        names = _eval_select_frames(sorted(os.listdir(d)), data_type, role)
        if not names:
            raise SystemExit(
                f"evaluate: no frames matching the '{data_type}' "
                f"convention in {d}")
        frames = []
        for n in names:
            img = cv2.imread(os.path.join(d, n))
            if img is None:
                raise SystemExit(f"evaluate: unreadable frame {d}/{n}")
            if role == "pred" and data_type == "every":
                # the reference nearest-resizes 'every' predictions to 256
                img = cv2.resize(img, (256, 256),
                                 interpolation=cv2.INTER_NEAREST)
            frames.append(img)
        return np.stack(frames)

    for name, d in (("--pred", args.pred), ("--gt", args.gt)):
        if not os.path.isdir(d):
            raise SystemExit(
                f"evaluate: {name} directory not found: {d} "
                "(expected per-video subdirectories of frames)")
    # openpose prediction roots hold auxiliary dirs whose names end in 'o'
    results = []
    vids = sorted(os.listdir(args.pred))
    if data_type == "openpose":
        vids = [v for v in vids if not v.endswith("o")]
    for vid in vids:
        pd, gd = os.path.join(args.pred, vid), os.path.join(args.gt, vid)
        if not (os.path.isdir(pd) and os.path.isdir(gd)):
            continue
        m = evaluate_video(read_frames(pd, "pred"), read_frames(gd, "gt"),
                           device=dev, **hooks)
        results.append(m)
        print(vid, {k: round(v, 4) for k, v in m.items()})
    if results:
        mean = {k: float(np.mean([r[k] for r in results]))
                for k in results[0]}
        print("dataset mean:", {k: round(v, 4) for k, v in mean.items()})
        os.makedirs("log_results_video", exist_ok=True)
        with open(os.path.join(
                "log_results_video",
                os.path.basename(args.pred) + ".errors.txt"), "a") as f:
            f.write(repr(mean) + "\n")


def cmd_gif(args) -> None:
    """Stack each video's final frames into a GIF (``test/convert_gif.py``:
    skips the mask_/coarse_/tsf_ variants, sorts by frame number, BGR->RGB,
    one GIF per video under ``<out_dir>/<project>/``)."""
    import re

    import cv2

    from jafpro_tpu_torch.data.texture import write_gif

    if not os.path.isdir(args.pred_dir):
        raise SystemExit(f"gif: --pred_dir not found: {args.pred_dir}")
    project = os.path.basename(os.path.normpath(args.pred_dir))
    frame_re = re.compile(r"^frame_(\d+)\.(jpg|png)$")
    for vid in sorted(os.listdir(args.pred_dir)):
        vdir = os.path.join(args.pred_dir, vid)
        if not os.path.isdir(vdir):
            continue
        matches = sorted(
            (int(m.group(1)), n)
            for n in os.listdir(vdir)
            if (m := frame_re.match(n)) is not None)
        if not matches:
            continue
        frames = []
        for _, n in matches:
            img = cv2.imread(os.path.join(vdir, n))
            if img is None:
                raise SystemExit(f"gif: unreadable frame {vdir}/{n}")
            frames.append(img[:, :, ::-1])
        out_dir = os.path.join(args.out_dir, project, vid + "_video")
        os.makedirs(out_dir, exist_ok=True)
        path = write_gif(os.path.join(out_dir, "video.gif"),
                         np.stack(frames), fps=args.fps)
        print("wrote", path)


def cmd_pack(args) -> None:
    from jafpro_tpu_torch.data.shardio import pack_dancevideo, pack_test_clips

    cfg = get_general_options()
    if args.kind == "clips":
        n = pack_test_clips(cfg.data_root, cfg.smpl_root, cfg.mask_root,
                            args.out, mode=args.mode, num_refs=args.num_refs)
        print(f"packed {n} clips into {args.out}")
        return
    n = pack_dancevideo(cfg.data_root, cfg.smpl_root, cfg.mask_root,
                        args.out, mode=args.mode, kind=args.kind,
                        samples_per_video=args.samples_per_video,
                        num_refs=args.num_refs, seed=args.seed)
    print(f"packed {n} samples into {args.out}")


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(prog="jafpro_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--stage", type=int, required=True, choices=[1, 2, 3, 4])
    t.add_argument("--exp_name", "-n", default="exp")
    t.add_argument("--debug", action="store_true",
                   help="save every 3 iterations")
    t.add_argument("--synthetic", action="store_true",
                   help="random batches on a small config (64 px, parts of "
                   "16, 2 refs, float32)")
    t.add_argument("--iters", type=int, default=10)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--batch-size", type=int, default=0,
                   help="override cfg.batch_size (0 = reference default: 4, "
                   "2 for stage 2)")
    t.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel ranks, one per card (NCCL) with "
                   "--device cuda, gloo ranks with --device cpu; the batch "
                   "is split evenly among them (0 or 1: one device)")
    t.add_argument("--shards", default="",
                   help="packed-shard dir or glob; training then streams "
                   "through the native reader")
    t.add_argument("--init-from", default="",
                   help="cross-stage warm start: load this stage's consumed "
                   "modules (stage 2: accu; 3: accu+inpaint; "
                   "4: accu+inpaint+bg+refine) from another experiment's "
                   "checkpoint, '<exp>[:<step>]' (newest if omitted); "
                   "optimizer state starts fresh")
    t.add_argument("--resume", action="store_true",
                   help="resume params, optimizer state and step from the "
                   "newest checkpoint of the experiment")
    t.add_argument("--no-face-gan", action="store_true",
                   help="no face-D updates and no face term in the G loss")
    t.add_argument("--dtype", default="",
                   help="override compute_dtype (e.g. float32)")
    t.add_argument("--device", default="cuda")
    t.add_argument("--trace-dir", default="",
                   help="run the training loop under torch.profiler: its "
                   "trace and the program's spans (spans.jsonl) go here")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer")
    i.add_argument("--exp_name", "-e", default="exp")
    i.add_argument("--num_refs", "-n", type=int, default=4)
    i.add_argument("--streams", default="final,coarse,mask,tsf",
                   help="comma-set of output streams to fetch and write "
                   "(must include 'final')")
    i.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel ranks, one per card (NCCL) with "
                   "--device cuda, gloo ranks with --device cpu; each "
                   "serves its share of the clip batches (0 or 1: one "
                   "device)")
    i.add_argument("--clips-per-batch", type=int, default=1,
                   help="clips generated together in one batched pass "
                   "(they must share their shapes)")
    i.add_argument("--packed-clips", default="",
                   help="serve from a clip pack (pack --kind clips --mode "
                   "test) instead of decoding each clip's images")
    i.add_argument("--device", default="cuda")
    i.add_argument("--trace-dir", default="",
                   help="run the serving loop under torch.profiler: its "
                   "trace and the program's spans (spans.jsonl) go here")
    i.set_defaults(fn=cmd_infer)

    e = sub.add_parser("evaluate")
    e.add_argument("--pred", required=True)
    e.add_argument("--gt", required=True)
    e.add_argument("--type", default="densepose",
                   choices=["densepose", "openpose", "every"],
                   help="prediction-dir naming convention "
                        "(test/video_evaluation.py:75-134)")
    e.add_argument("--no-deep-metrics", action="store_true",
                   help="skip the VGG/FlowNetSD metrics (4 fast metrics)")
    e.add_argument("--device", default="cuda")
    e.set_defaults(fn=cmd_evaluate)

    g = sub.add_parser("gif", help="stack generated frames into per-video "
                       "GIFs")
    g.add_argument("--pred_dir", required=True,
                   help="inference output dir (per-video subdirs of frames)")
    g.add_argument("--out_dir", default="gif_result")
    g.add_argument("--fps", type=int, default=10)
    g.set_defaults(fn=cmd_gif)

    k = sub.add_parser(
        "pack", help="pack DanceVideo training samples into shards for "
        "`train --shards`, or whole serving clips for `infer --packed-clips`")
    k.add_argument("--out", required=True)
    k.add_argument("--mode", default="train", choices=["train", "test"])
    k.add_argument("--kind", default="interval",
                   choices=["interval", "textonly", "clips"],
                   help="interval = stage-3/4 records, textonly = stage-1/2,"
                   " clips = whole serving clips for `infer --packed-clips`")
    k.add_argument("--samples_per_video", type=int, default=4)
    k.add_argument("--num_refs", type=int, default=4)
    k.add_argument("--seed", type=int, default=0)
    k.set_defaults(fn=cmd_pack)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
