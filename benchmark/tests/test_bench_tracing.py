"""The readers of the program's spans (``benchmark/program_spans.py`` and
the ten metrics over it): each reads a finite number in a traced run of
its cell at the test's size, and nothing in an untraced run or from a
program that records no spans."""

import math
import os
import time
import types

import pytest

from benchmark import harness
from benchmark.tests import tiny

METRICS = {
    "gen-serve-batch1": ["serve.h2d_ms.serve", "serve.sync_ms.serve",
                         "gen.flow_ms.serve"],
    "gen-request-refs1to4": ["serve.sync_ms.request",
                             "serve.fetch_ms.request"],
    "train4-batch4": ["train.forward_ms", "train.disc_ms",
                      "train.gen_backward_ms", "train.optim_ms",
                      "train.enqueue_ms"],
}


def reader(root, name):
    return harness.load_module(os.path.join(root, "benchmark", "metrics",
                                            name + ".py"))


@pytest.mark.parametrize("cell", sorted(METRICS))
def test_read_in_a_traced_run_only(tiny_root, cell):
    from jafpro_tpu_torch.utils import profiling

    readings = {}
    t0 = time.time_ns()
    traced = tiny.run(tiny_root, cell, trace=True)
    for name in METRICS[cell]:
        v = traced["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
        assert traced["metrics"][name]["unit"] == "ms"
    plain = tiny.run(tiny_root, cell)
    assert not set(METRICS[cell]) & set(plain["metrics"])
    # an untraced run, and a traced one whose window holds no span
    for trace, spans in ((False, []), (True, [("bench.x", t0, t0 + 1)])):
        run = types.SimpleNamespace(trace=trace, spans=spans, readings={
            "clips": 1, "requests": 1, "steps": 1})
        for name in METRICS[cell]:
            assert reader(tiny_root, name).read(run) is None
    if cell != "train4-batch4":
        return
    # the three phases of a step add up to the step's stream time
    steps = [r for r in profiling.spans(t0) if r["name"] == "train.step"]
    per_step = sum(r["stream_ms"] for r in steps) / len(steps)
    parts = sum(traced["metrics"][n]["value"] for n in (
        "train.forward_ms", "train.disc_ms", "train.gen_backward_ms"))
    assert parts == pytest.approx(per_step, rel=0.05)
    assert traced["metrics"]["train.optim_ms"]["value"] < parts


def test_program_without_spans(tiny_root, monkeypatch):
    """A program whose profiling module has no ``spans`` (the parent
    commit's): a traced run reports its other metrics and leaves these
    out."""
    from jafpro_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    res = tiny.run(tiny_root, "gen-request-refs1to4", trace=True)
    assert res["correct"]
    assert "serve.load_ms.request" in res["metrics"]
    assert not set(METRICS["gen-request-refs1to4"]) & set(res["metrics"])
