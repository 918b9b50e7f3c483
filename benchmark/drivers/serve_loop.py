"""Driver: a closed loop through the port's serving loop, as ``cli infer``
serves packed clips.

``cli.serve`` over ``cli.open_clip_source`` (the pack reader),
``cli.generate_group(cli.serving_generator(...))`` (one
``generate_batch`` per group of ``clips_per_batch`` clips, frames in one
group, the flow branch batched, uint8 on the card, waited for) and a
writer that copies the streams to the host with ``cli.fetch_clips`` (the
JPEG encode is left out). Loads are prefetched ``prefetch`` groups ahead
and ``writers`` threads copy out, as the CLI's defaults. Groups are drawn
from the pool by the run's seed; the window feeds groups until
``--seconds`` have passed and ends when the last one is on the host.

Correctness: a sample of the served clips, drawn by the seed while the
window runs (a reservoir), is regenerated by the reference.
"""

from __future__ import annotations

import collections.abc
import time

from benchmark import traffic
from benchmark.drivers_common import Sample, reference_checks
from benchmark.program import build_pipeline, free_program


class Window(collections.abc.Sequence):
    """The window's groups: drawn lazily by the seed; iteration stops
    once the deadline has passed (``run_overlapped`` iterates and indexes
    ahead for its prefetch)."""

    def __init__(self, draw, deadline: float):
        self.draw, self.deadline, self.items = draw, deadline, []

    def __len__(self):
        return 1 << 40

    def __getitem__(self, i):
        while len(self.items) <= i:
            self.items.append(self.draw())
        return self.items[i]

    def __iter__(self):
        i = 0
        while time.perf_counter() < self.deadline:
            yield self[i]
            i += 1


def _draw_groups(vids, size, seed, stream):
    it = traffic.draws(seed, len(vids), stream)
    return lambda: tuple(vids[next(it)] for _ in range(size))


def setup(run):
    from jafpro_tpu_torch import cli

    tr = run.traffic
    refs = tr["pool"]["refs"][0]
    packs = traffic.clip_pools(run.cfg, tr["pool"])
    pipe, pcfg = build_pipeline(run)
    gen = cli.serving_generator(pipe, pcfg)
    vids, load = cli.open_clip_source(pcfg, refs, packs[refs])
    state = {"pipe": pipe, "gen": gen, "load": load, "vids": vids,
             "compute": cli.generate_group(gen)}
    # warm-up: the cell's one shape, twice (the first builds the kernel
    # library and picks the convolutions' algorithms)
    warm = _draw_groups(vids, tr["clips_per_batch"], run.seed, 1)
    cli.serve([warm(), warm()], load, state["compute"],
              lambda g, out: cli.fetch_clips(g, out, tr["streams"]),
              prefetch=tr["prefetch"], writers=tr["writers"])
    return state


def measure(run, state):
    from jafpro_tpu_torch import cli

    tr = run.traffic
    gen = state["gen"]
    gen.time_stages = run.trace
    stage_ms = collections.Counter()
    sample = Sample(run.workload["check"]["sample"], run.seed)

    def compute(group, clips):
        with run.span("bench.compute"):
            out = state["compute"](group, clips)
        if run.trace:
            stage_ms.update(gen.stage_ms)
        return out

    def write(group, out):
        with run.span("bench.write"):
            host = cli.fetch_clips(group, out, tr["streams"])
        for vid in group:
            sample.offer((vid, host[vid]))

    def load(group):
        with run.span("bench.load"):
            return state["load"](group)

    draw = _draw_groups(state["vids"], tr["clips_per_batch"], run.seed, 0)
    t0 = time.perf_counter()
    stats = cli.serve(Window(draw, t0 + run.seconds), load, compute, write,
                      prefetch=tr["prefetch"], writers=tr["writers"])
    window = time.perf_counter() - t0
    clips = stats["items"] * tr["clips_per_batch"]
    run.attempted = clips
    state["sample"] = sample.kept
    run.readings.update(
        serve_stats=stats, window_s=window, clips=clips,
        clips_per_s=clips / window, frames=tr["pool"]["frames"],
        refs=tr["pool"]["refs"][0], poses_per_launch=(
            tr["clips_per_batch"] * tr["pool"]["frames"]),
        stage_ms_per_clip={k: v / clips for k, v in stage_ms.items()})
    return {"clips_per_s": clips / window}


def check(run, state):
    kept = [(int(vid.rsplit("_", 1)[1]), run.traffic["pool"]["refs"][0],
             served) for vid, served in state.get("sample", [])]
    free_program(state)
    return reference_checks(run, kept)


def control(run, mode: str = "float8"):
    """The correctness control: the reference in ``mode`` put in the
    program's place, on as many clips as a run checks, drawn by the seed."""
    pool = run.traffic["pool"]
    refs = pool["refs"][0]
    draw = traffic.draws(run.seed, pool["clips"], 9)
    kept = [(next(draw), refs, None)
            for _ in range(run.workload["check"]["sample"])]
    return reference_checks(run, kept, mode)
