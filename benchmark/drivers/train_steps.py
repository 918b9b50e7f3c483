"""Driver: training stage 4 as ``cli train --stage 4 --shards`` feeds and
steps it, for a window of time.

One ``cli.make_step(pipe, 4)`` step over ``train.common.TrainState``;
batches from ``ShardReader`` (shuffled by the run's seed, looping) through
``collapse_target_dims`` and the reference-count curriculum
(``apply_curriculum``) to the device (``to_device``) on one feeder thread
with a queue of ``queue`` batches, as ``cli.run_train`` feeds; each step
waited for and its losses read on the host, as ``run_train`` logs them.
``run_train`` has no form bounded by time, so this loop stands in for it
around the same calls. No checkpoint falls in the window
(``model_save_interval`` is 3000 steps).

Set-up takes the first ``check.steps`` steps through that same call and
feed; the reference follows them from the same seeded weights on the same
batches. The window goes on with the same state.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from benchmark import compare, traffic
from benchmark.program import build_pipeline, free_program, reference_faces

STAGE = 4


def _named(pipe, names):
    return {f"{n}.{k}": p for n in names
            for k, p in getattr(pipe, n).named_parameters()}


def _feeder(run, state):
    from jafpro_tpu_torch.data.shardio import (
        ShardReader, collapse_target_dims, interval_spec)
    from jafpro_tpu_torch.train.common import apply_curriculum, to_device

    cfg, tr = run.cfg, run.traffic
    spec = interval_spec(
        num_refs=cfg["maximum_ref_frames"], image_size=cfg["image_size"],
        part_size=cfg["part_size"], num_parts=cfg["num_parts"],
        num_verts=cfg["num_verts"])
    reader = ShardReader(spec, [traffic.record_pool(cfg, tr["pool"])],
                         batch=cfg["batch_size"],
                         prefetch=tr["reader_prefetch"],
                         threads=tr["reader_threads"],
                         seed=run.seed % 2 ** 32, shuffle=True, loop=True)
    rng = np.random.RandomState(run.seed % 2 ** 32)
    q: "queue.Queue" = queue.Queue(maxsize=tr["queue"])
    stop = threading.Event()
    kept = []
    n_keep = run.workload["check"]["steps"]

    def feed():
        try:
            while not stop.is_set():
                b = apply_curriculum(
                    dict(collapse_target_dims(spec, next(reader))), STAGE,
                    rng, cfg["maximum_ref_frames"])
                if len(kept) < n_keep:
                    kept.append({k: np.array(v) for k, v in b.items()})
                b = to_device(b, run.device)
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        pass
        except BaseException as e:  # re-raised by the step loop
            q.put(e)

    thread = threading.Thread(target=feed, daemon=True)
    thread.start()

    def next_batch():
        b = q.get()
        if isinstance(b, BaseException):
            raise b
        return b

    def close():
        stop.set()
        thread.join()
        reader.close()

    state.update(next_batch=next_batch, close=close, kept=kept)


def _step(state):
    s, m = state["step"](state["train"], state["next_batch"]())
    state["train"] = s
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: float(v) for k, v in m.items()}


def setup(run):
    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.train.common import TrainState

    pipe, _ = build_pipeline(run)
    step, lrs = cli.make_step(pipe, STAGE)
    state = {"pipe": pipe, "step": step, "train": TrainState(pipe, lrs),
             "lrs": lrs}
    _feeder(run, state)
    named = _named(pipe, lrs)
    theta0 = {k: p.detach().clone() for k, p in named.items()}
    opts = state["train"].opts
    losses, moment = [], {}
    for i in range(run.workload["check"]["steps"]):
        losses.append(_step(state))
        if i == 0:
            for n in lrs:
                for k, p in getattr(pipe, n).named_parameters():
                    m = opts[n].state[p].get("exp_avg")   # none: no update
                    moment[f"{n}.{k}"] = 0.0 if m is None else float(m.norm())
    change = {k: float((p.detach() - theta0[k]).norm())
              for k, p in named.items()}
    del theta0
    state["program"] = {"losses": losses, "moment": moment,
                        "change": change}
    return state


def measure(run, state):
    B = run.cfg["batch_size"]
    waits = []
    next_batch = state["next_batch"]

    def timed_next():
        t = time.perf_counter()
        with run.span("bench.feed_wait"):
            b = next_batch()
        waits.append(time.perf_counter() - t)
        return b

    state["next_batch"] = timed_next
    steps = 0
    t0 = time.perf_counter()
    while True:
        with run.span("bench.step"):
            _step(state)
        steps += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    window = time.perf_counter() - t0
    run.attempted = steps
    run.readings.update(window_s=window, steps=steps,
                        samples_per_s=steps * B / window,
                        feed_wait_ms=1e3 * sum(waits) / len(waits))
    return {"train_samples_per_s": steps * B / window}


def check(run, state):
    state["close"]()
    prog, kept = state["program"], state["kept"]
    free_program(state)
    stats = run.readings.setdefault("gap_stats", {})
    return _checks(run, gaps_of(prog, _reference(run, kept), stats))


def _checks(run, gaps):
    """The numbers the workload file gives a limit: the losses and the
    change. The first gradient's worst leaf is read (calibration) but not
    compared: its one-leaf rounding noise and the control overlap."""
    from benchmark.harness import Check

    limits = run.workload["check"]["limits"]
    return [Check(k, gaps[k], v) for k, v in limits.items()]


def _reference(run, batches, mode: str = "float32") -> dict:
    from benchmark import weights
    from benchmark.reference import nets, precision

    precision.strict_float32()
    cfg = run.cfg
    net = nets.build(cfg["image_size"], cfg["face_crop_size"],
                     cfg["num_parts"], device=run.device)
    weights.fill(net, run.seed)
    with precision.use(mode):
        return follow(net, reference_faces(run), cfg, batches)


def control(run, mode: str = "float8"):
    """The reference put in the program's place on the batches the cell's
    first steps take: in float8 (``"float8"``, the control), or with the
    last half of each batch left out and the means over the rest
    (``"half_batch"``, a fault)."""
    state = {}
    _feeder(run, state)
    batches = [state["next_batch"]() for _ in range(
        run.workload["check"]["steps"])]
    state["close"]()
    del batches
    kept = state["kept"]
    ref = _reference(run, kept)
    if mode == "half_batch":
        half = run.cfg["batch_size"] // 2
        other = _reference(run, [{k: v[:half] for k, v in b.items()}
                                 for b in kept])
    else:
        other = _reference(run, kept, mode)
    stats = run.readings.setdefault("gap_stats", {})
    return _checks(run, gaps_of(other, ref, stats))


def follow(net, faces, cfg, batches) -> dict:
    """The reference's losses, first moments and change over ``batches``."""
    from benchmark.reference.train import Stage4

    st = Stage4(net, faces, cfg)
    named = {f"{n}.{k}": p for n in st.params
             for k, p in getattr(net, n).named_parameters()}
    theta0 = {k: p.detach().clone() for k, p in named.items()}
    losses, moment = [], {}
    for i, b in enumerate(batches):
        losses.append({k: float(v) for k, v in st.step(b).items()})
        if i == 0:
            for n, o in st.opts.items():
                for k, p in getattr(net, n).named_parameters():
                    moment[f"{n}.{k}"] = float(o.state[p]["exp_avg"].norm())
    change = {k: float((p.detach() - theta0[k]).norm())
              for k, p in named.items()}
    return {"losses": losses, "moment": moment, "change": change}


def gaps_of(prog: dict, ref: dict, stats: dict = None) -> dict:
    """The three numbers; ``stats``, when given, gets each leaf number's
    median and 90th percentile leaf and its worst leaf's name and norms
    (what the limits' readings are looked at with)."""
    names = sorted(ref["moment"])
    if sorted(prog["moment"]) != names or sorted(prog["change"]) != names:
        inf = float("inf")
        return {"loss": inf, "grad": inf, "change": inf}
    g_ref = [ref["moment"][k] for k in names]
    keep = compare.moving_leaves(g_ref)
    out = {"loss": compare.loss_gap(prog["losses"], ref["losses"])}
    for key, src, kp in (("grad", "moment", None), ("change", "change", keep)):
        p = [prog[src][k] for k in names]
        r = [ref[src][k] for k in names]
        g = compare.leaf_gaps(p, r, kp)
        out[key] = float(np.nanmax(g))
        if stats is not None:
            w = int(np.nanargmax(g))
            stats[key] = {"p50": float(np.nanmedian(g)),
                          "p90": float(np.nanpercentile(g, 90)),
                          "worst": names[w], "prog": p[w], "ref": r[w],
                          "median_ref": float(np.median(r))}
    return out
