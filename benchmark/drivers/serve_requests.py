"""Driver: one client that sends a clip request and waits for its frames
before it sends the next (a closed loop of one).

Each request is one ``cli.serve([clip], ...)`` call over the pack reader
of its reference count, ``cli.generate_group(cli.serving_generator(...))``
and a writer that copies ``streams`` to the host (``cli.fetch_clips``), so
its load, generation and copy run in series and the loop's thread pools
start anew each time. A request's latency is that call's wall time. The
reference counts of ``pool["refs"]`` come in blocks that hold each count
once, in an order drawn by the run's seed, so every seed sends the same mix
(the tail is the tail of one mix, not of a mix the seed shifts); the clip
of each request is drawn uniformly. Set-up warms up every reference count.

Correctness: for each reference count, one of its served requests, drawn
by the seed, is regenerated by the reference.
"""

from __future__ import annotations

import collections
import math
import time

from benchmark import traffic
from benchmark.drivers_common import Sample, reference_checks
from benchmark.program import build_pipeline, free_program


def setup(run):
    from jafpro_tpu_torch import cli

    tr, pool = run.traffic, run.traffic["pool"]
    packs = traffic.clip_pools(run.cfg, pool)
    pipe, pcfg = build_pipeline(run)
    gen = cli.serving_generator(pipe, pcfg)
    sources = {r: cli.open_clip_source(pcfg, r, packs[r])
               for r in pool["refs"]}
    state = {"pipe": pipe, "gen": gen, "sources": sources,
             "compute": cli.generate_group(gen)}
    for r in pool["refs"]:          # every shape, twice
        vids, load = sources[r]
        for i in range(2):
            cli.serve([(vids[i],)], load, state["compute"],
                      lambda g, out: cli.fetch_clips(g, out, tr["streams"]),
                      prefetch=tr["prefetch"], writers=tr["writers"])
    return state


def p95(values):
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def measure(run, state):
    from jafpro_tpu_torch import cli

    tr, pool = run.traffic, run.traffic["pool"]
    gen = state["gen"]
    gen.time_stages = run.trace
    samples = {r: Sample(1, run.seed + r) for r in pool["refs"]}
    rng = traffic.rng_for(run.seed, 3)
    block = []
    lat, load_ms, texture_ms = [], [], []
    by_refs = collections.defaultdict(list)

    def compute(group, clips):
        with run.span("bench.compute"):
            out = state["compute"](group, clips)
        if run.trace:
            texture_ms.append(gen.stage_ms.get("accumulate+inpaint", 0.0))
        return out

    t0 = time.perf_counter()
    while time.perf_counter() < t0 + run.seconds:
        if not block:
            block = [int(r) for r in rng.permutation(pool["refs"])]
        r = block.pop()
        vids, load = state["sources"][r]
        vid = vids[int(rng.integers(0, len(vids)))]
        got = {}

        def write(group, out):
            with run.span("bench.write"):
                got.update(cli.fetch_clips(group, out, tr["streams"]))

        def timed_load(group):
            with run.span("bench.load"):
                return load(group)

        ts = time.perf_counter()
        stats = cli.serve([(vid,)], timed_load, compute, write,
                          prefetch=tr["prefetch"], writers=tr["writers"])
        lat.append(time.perf_counter() - ts)
        by_refs[r].append(lat[-1])
        load_ms.append(stats["load_ms"])
        samples[r].offer((vid, got[vid]))
    window = time.perf_counter() - t0
    run.attempted = len(lat)
    state["sample"] = {r: s.kept for r, s in samples.items()}
    run.readings.update(
        window_s=window, requests=len(lat), latencies_s=lat,
        load_ms_per_request=sum(load_ms) / len(load_ms),
        texture_ms_per_request=(sum(texture_ms) / len(texture_ms)
                                if texture_ms else None),
        p95_by_refs_ms={r: 1e3 * p95(v) for r, v in by_refs.items()})
    return {"clip_p95_ms": 1e3 * p95(lat)}


def check(run, state):
    kept = [(int(vid.rsplit("_", 1)[1]), r, served)
            for r, items in sorted(state.get("sample", {}).items())
            for vid, served in items]
    free_program(state)
    return reference_checks(run, kept)


def control(run, mode: str = "float8"):
    """The correctness control: the reference in ``mode`` put in the
    program's place, on one clip of each reference count drawn by the
    seed."""
    pool = run.traffic["pool"]
    draw = traffic.draws(run.seed, pool["clips"], 9)
    return reference_checks(run, [(next(draw), r, None)
                                  for r in pool["refs"]], mode)
