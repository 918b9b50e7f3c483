"""The harness: finds a cell's files by name, runs its driver's set-up,
window and check, reads the trace and the per-layer metrics, and prints
the result.

A cell named in ``BENCHMARK.json`` is found by name: its configuration
(the file its ``configs`` entry names), ``workloads/<cell>.json`` (the
driver and the correctness limits), ``traffic/<traffic>.json`` (the
traffic's parameters), ``drivers/<driver>.py`` and, for each per-layer
metric, ``metrics/<metric>.py``. Adding a cell, a traffic mix, a driver or
a metric takes new files and entries only.

A driver module has three functions: ``setup(run)`` builds the program and
warms up every shape the cell uses; ``measure(run, state)`` runs the
window and returns the end-to-end values; ``check(run, state)`` frees the
program's state, runs the reference and returns the compared numbers.
Drivers put what per-layer readers read into ``run.readings``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "jafpro_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: Optional[str] = None):
    """A Python file as a module (file names may hold dots and dashes)."""
    name = name or "bench_" + os.path.basename(path)[:-3].replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(root: str, name: str):
    """``benchmark/drivers/<name>.py`` of the checkout at ``root``."""
    return load_module(os.path.join(root, "benchmark", "drivers",
                                    name + ".py"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_name_power() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or what
    stopped it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """One run of one cell: what the drivers and readers share."""

    root: str
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: "object"              # torch.device
    t_start: float
    bench: dict = dataclasses.field(default_factory=dict)
    entry: dict = dataclasses.field(default_factory=dict)
    cfg: dict = dataclasses.field(default_factory=dict)
    workload: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    readings: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    trace_summary: Optional[dict] = None
    spans: list = dataclasses.field(default_factory=list)

    @property
    def bench_dir(self) -> str:
        return os.path.join(self.root, "benchmark")

    def open_window(self) -> None:
        """Set-up ends here: process start to now."""
        self.setup_s = time.perf_counter() - self.t_start

    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda():
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own around a call into the program,
        kept (on the clock the profiler stamps events with) when the run
        is traced; the trace's idle gaps are labelled by them."""
        if not self.trace:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def resolve(root: str, cell: str) -> dict:
    """The cell's entries and files, by name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json "
                         f"({[w['name'] for w in bench['workloads']]})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bdir = os.path.join(root, "benchmark")
    return {
        "bench": bench, "entry": entry,
        "cfg": load_json(os.path.join(root, conf["file"])),
        "workload": load_json(os.path.join(bdir, "workloads", cell + ".json")),
        "traffic": load_json(os.path.join(bdir, "traffic",
                                          entry["traffic"] + ".json")),
    }


def per_layer_metrics(run: Run) -> List[dict]:
    """The per-layer metrics this cell reports: those listing it, and
    those without a list whose end-to-end metric the cell reports."""
    mine = set(end_to_end_names(run))
    out = []
    for m in run.bench["per_layer"]:
        cells = m.get("workloads")
        if (run.cell in cells) if cells is not None else (m["moves"] in mine):
            out.append(m)
    return out


def end_to_end_names(run: Run) -> List[str]:
    return [m["name"] for m in run.bench["end_to_end"]
            if run.cell in m.get("workloads", [run.cell])]


# ---- the profiler's trace ----------------------------------------------

@contextlib.contextmanager
def profiled(run: Run):
    """``torch.profiler`` over the window when the run is traced; its
    summary lands in ``run.trace_summary``."""
    if not run.trace:
        yield
        return
    import torch

    # the card's activity only: the host's side is the benchmark's spans
    act = torch.profiler.ProfilerActivity
    prof = torch.profiler.profile(
        activities=[act.CUDA if run.cuda() else act.CPU])
    prof.start()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        run.sync()
        window = time.perf_counter() - t0
        prof.stop()
        run.trace_summary = summarise(prof.profiler.kineto_results.events(),
                                      window, run.spans)
        del prof


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge (n, 2) intervals sorted by start."""
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > reach[:-1]]
    first = np.flatnonzero(new)
    return np.stack([iv[first, 0], np.maximum.reduceat(iv[:, 1], first)], 1)


def summarise(events, window_s: float, spans=()) -> dict:
    """Device time by operation name, the union of device intervals
    (busy), and the longest idle gaps labelled by the innermost of the
    benchmark's spans on the host at each gap's middle."""
    from torch.autograd import DeviceType

    dev = [(e.start_ns(), e.duration_ns(), e.name()) for e in events
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation()]
    by_name: Dict[str, list] = {}
    for _, d, n in dev:
        acc = by_name.setdefault(n, [0.0, 0])
        acc[0] += d * 1e-9
        acc[1] += 1
    summary = {"window_s": window_s, "busy_s": 0.0, "device_ops": [],
               "idle_gaps": [], "by_name": by_name}
    if not dev:
        return summary
    iv = np.asarray([(s, s + d) for s, d, _ in dev], np.float64)
    merged = _union(iv[np.argsort(iv[:, 0], kind="stable")])
    summary["busy_s"] = float((merged[:, 1] - merged[:, 0]).sum() * 1e-9)
    summary["device_ops"] = [
        [n, v[0]] for n, v in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:10]]
    gaps = np.stack([merged[:-1, 1], merged[1:, 0]], 1)
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:1000]]
    hs = np.asarray([t0 for _, t0, _ in spans], np.float64)
    he = np.asarray([t1 for _, _, t1 in spans], np.float64)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        on = np.flatnonzero((hs <= mid) & (he >= mid))
        key = (spans[on[np.argmin((he - hs)[on])]][0] if on.size
               else "host: outside the benchmark's spans")
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    summary["idle_gaps"] = [[n, v] for n, v in sorted(
        idle.items(), key=lambda kv: -kv[1])[:10]]
    return summary


# ---- one run -----------------------------------------------------------

def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, out=sys.stdout, err=sys.stderr,
             readings: Optional[dict] = None) -> dict:
    """Set up, measure and check one cell on ``device``; returns the
    result line's object (also printed). ``readings``, when given, gets
    the drivers' readings."""
    import torch

    found = resolve(root, cell)
    run = Run(root=root, cell=cell, seed=seed, seconds=seconds,
              trace=trace, device=device, t_start=t_start, **found)
    driver = load_driver(root, run.workload["driver"])
    card = card_name_power() if run.cuda() else "cpu"
    print(f"[bench] {cell} seed {seed} seconds {seconds} trace {int(trace)}"
          f" on {card}", file=err, flush=True)
    state = driver.setup(run)
    run.sync()
    run.open_window()
    with profiled(run):
        e2e = driver.measure(run, state)
    peak = (torch.cuda.max_memory_allocated(device) if run.cuda() else 0)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded during the run: {bad}")
    checks = driver.check(run, state)
    del state
    gc.collect()
    if readings is not None:
        readings.update(run.readings)
    if trace:
        metrics = {}
        for m in per_layer_metrics(run):
            reader = load_module(os.path.join(run.bench_dir, "metrics",
                                              m["name"] + ".py"))
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(e2e, setup_s=run.setup_s)
        units = {m["name"]: m["unit"] for m in run.bench["end_to_end"]}
        metrics = {n: {"value": float(e2e[n]), "unit": units[n]}
                   for n in end_to_end_names(run)}
    if device.type == "cuda":
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": int(run.entry["chips"]),
                    "memory_peak_bytes": int(peak)}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks) and bool(checks),
              "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": metrics, "device": dev_info}
    if trace and run.trace_summary is not None:
        ts = run.trace_summary
        dev_info["busy_s"] = ts["busy_s"]
        dev_info["window_s"] = ts["window_s"]
        result["breakdown"] = {"device_ops": ts["device_ops"],
                               "idle_gaps": ts["idle_gaps"]}
    result["card"] = card
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded during the run: {bad}")
    for c in checks:
        print(f"[check] {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result
