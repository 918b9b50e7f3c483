"""The port's spans (``utils/profiling.py``) on the CPU.

Off (no profiler running), a served clip, the serving loop and a stage-4
step record nothing and make no CUDA event, no ``record_function`` and no
synchronize. On
(under ``torch.profiler``), the spans carry their threads, parents and
items, share the profiler's clock, and a stage-4 step splits into phases
that follow one another. A fake CUDA event stands in for the card's where
the test needs the device path; the configuration is small (32 px, 4
parts of 16 px, 2 references, 4 frames) at the nets' full widths.
"""

import json
import os
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from jafpro_tpu_torch import cli
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.infer import STAGES, VideoGenerator, stack_clips
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.train.common import (
    TrainState, synthetic_batch, to_device)
from jafpro_tpu_torch.utils import profiling
from jafpro_tpu_torch.utils.meshproxy import uv_sphere

torch.set_num_threads(1)
S, PS, P, R, T = 32, 16, 4, 2, 4
SERVE_SPANS = {"serve.load", "serve.compute", "serve.write"}


class FakeEvent:
    """``torch.cuda.Event`` on the host clock, counted."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def counted(monkeypatch):
    """A fresh recorder; CUDA events possible (fakes) and counted, and
    ``record_function`` ranges counted."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder())
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    ranges = []
    real = torch.profiler.record_function

    def record_function(name, *a):
        ranges.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return ranges


@pytest.fixture(scope="module")
def world():
    verts0, faces = uv_sphere(8, 10)
    cfg = Config(image_size=S, part_size=PS, num_parts=P,
                 maximum_ref_frames=R, face_crop_size=16,
                 compute_dtype="float32", batch_size=2)
    with mock.patch("jafpro_tpu_torch.pipeline.init_params_",
                    lambda *a: None):
        torch.manual_seed(0)
        pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
            faces=faces, image_size=S), device="cpu")
    return {"pipe": pipe, "verts": verts0 * np.float32([0.35, 0.9, 0.35])}


def make_clip(world, seed):
    rng = np.random.RandomState(seed)
    verts = world["verts"][None] + rng.normal(scale=0.02, size=(T, 1, 3))
    verts[..., 2] += 2.0
    iuv = np.zeros((T, S, S, 3), np.float32)
    iuv[..., 0] = rng.randint(0, P + 1, (T, S, S))
    iuv[..., 1:] = rng.randint(0, 256, (T, S, S, 2))
    clip = {
        "src_parts": rng.uniform(-1, 1, (1, R, P, PS, PS, 3)),
        "src_mask_parts": rng.rand(1, R, P, PS, PS) > 0.5,
        "ref_mask": np.ones((1, R)),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)),
        "src_imgs": rng.uniform(-1, 1, (R, S, S, 3)),
        "tgt_iuv255": iuv,
        "tgt_iuv": (iuv / 255.0 - 0.5) * 2.0,
        "smpl_mask": rng.rand(T, S, S, 1) > 0.2,
        "cams": np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1)),
        "verts": verts,
    }
    clip = {k: np.asarray(v, np.float32) for k, v in clip.items()}
    clip["chosen_frames"] = np.array([0, T - 1], np.int32)
    return clip


def stage4_batch(world, seed=0):
    rng = np.random.RandomState(seed)
    V = world["verts"].shape[0]
    b = synthetic_batch(rng, batch=2, num_refs=R, num_parts=P, part_size=PS,
                        image_size=S, num_verts=V)
    b["prev_verts"] = np.tile(world["verts"][None] + np.float32([0, 0, 2]),
                              (2, 1, 1))
    b["tgt_verts"] = b["prev_verts"] + np.float32([0.02, 0.0, 0.0])
    return to_device(b, "cpu")


def serve_two(world):
    """``cli.serve`` over two groups as ``cli infer`` serves them; returns
    its stats and the writer's clips."""
    gen = cli.serving_generator(world["pipe"], world["pipe"].cfg)
    clips = {("a",): make_clip(world, 1), ("b",): make_clip(world, 2)}
    got = {}

    def write(group, out):
        got.update(cli.fetch_clips(group, out, cli.STREAMS))

    stats = cli.serve(list(clips), lambda g: [clips[g]],
                      cli.generate_group(gen), write)
    return stats, got


def stage4_step(world):
    step, lrs = cli.make_step(world["pipe"], 4)
    state = TrainState(world["pipe"], lrs)
    return step(state, stage4_batch(world))


def by_name(records, name):
    return [r for r in records if r["name"] == name]


def test_off_records_nothing(world, counted, monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    monkeypatch.setattr(FakeEvent, "synchronize",
                        lambda self: syncs.append(self))
    t0 = time.time_ns()
    gen = VideoGenerator(world["pipe"], frame_batch=T, flow_mode="batch")
    gen.generate_batch(stack_clips([make_clip(world, 0)]))
    stats, got = serve_two(world)
    stage4_step(world)
    assert profiling.spans(t0) == []
    assert FakeEvent.made == 0 and counted == [] and syncs == []
    assert set(stats) == {"items", "loop_seconds", "load_ms", "compute_ms",
                          "write_ms"}
    assert stats["items"] == 2 and sorted(got) == ["a", "b"]
    assert all(stats[k] > 0 for k in ("loop_seconds", "load_ms",
                                      "compute_ms", "write_ms"))
    assert gen.stage_ms == {}


def test_off_returns_one_shared_context():
    a, b = profiling.span("x", device=True), profiling.span("y", n=3)
    assert a is b and not a
    with a as s:
        assert s is a


def test_on_threads_parents_and_items(world, counted):
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stats, got = serve_two(world)
    recs = profiling.spans(t0)
    ids = {r["id"]: r for r in recs}
    main = threading.get_ident()
    phase = {(r["name"], tuple(r["item"])): r for r in recs
             if r["name"] in SERVE_SPANS}
    assert len(phase) == 6
    for group in (("a",), ("b",)):
        load, comp, write = (phase[("serve." + p, group)]
                             for p in ("load", "compute", "write"))
        assert comp["thread"] == main
        assert load["thread"] != main and write["thread"] != main
        assert load["parent"] is None and comp["parent"] is None
        assert load["end_ns"] <= comp["start_ns"]
        assert comp["end_ns"] <= write["start_ns"]
        kids = [r for r in recs if r["parent"] == comp["id"]]
        assert [r["name"] for r in kids][:2] == ["gen.h2d", "gen.texture"]
        assert {r["name"] for r in kids} == {"gen.h2d", "serve.sync",
                                             *STAGES}
        assert all(r["thread"] == main and r["item"] == comp["item"]
                   for r in kids)
        fetch = [r for r in recs if r["parent"] == write["id"]]
        assert [r["name"] for r in fetch] == ["serve.fetch"]
        assert fetch[0]["thread"] == write["thread"]
        assert fetch[0]["n"] == sum(got[group[0]][s].nbytes
                                    for s in cli.STREAMS)
        h2d = [r for r in kids if r["name"] == "gen.h2d"][0]
        assert h2d["n"] == sum(v.nbytes for v in stack_clips(
            [make_clip(world, 1)]).values())
    flows = [r for r in recs if r["name"].startswith("flow.")]
    assert {r["name"] for r in flows} == {
        "flow.project", "flow.prepare_faces", "flow.raster", "flow.bc_warp"}
    assert all(ids[r["parent"]]["name"] == "gen.flow" for r in flows)
    # device spans made their two events each and read them
    device = [r for r in recs if r["stream_ms"] is not None]
    assert FakeEvent.made == 2 * len(device) > 0
    assert {r["name"] for r in device} == {*STAGES, *(r["name"]
                                                      for r in flows)}
    assert all(r["stream_ms"] >= 0 for r in device)
    # each span is also a record_function range of its name; the profiler
    # keeps those of the thread that started it
    assert sorted(counted) == sorted(r["name"] for r in recs)
    names = {e.name for e in prof.events()}
    assert {"serve.compute", "gen.h2d", "serve.sync", *STAGES} <= names
    assert set(stats) == {"items", "loop_seconds", "load_ms", "compute_ms",
                          "write_ms"}
    assert stats["compute_ms"] == pytest.approx(
        np.mean([phase[("serve.compute", g)]["host_ms"]
                 for g in (("a",), ("b",))]))


def test_shared_clock_with_the_profiler(counted):
    a = torch.ones(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("probe"):
            a.matmul(a)
    (rec,) = by_name(profiling.spans(), "probe")
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert rec["start_ns"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= rec["end_ns"]


def test_stage4_step_phases_follow_one_another(world, counted):
    t0 = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        stage4_step(world)
    recs = profiling.spans(t0)
    (step,) = by_name(recs, "train.step")
    kids = [r for r in recs if r["parent"] == step["id"]]
    assert [r["name"] for r in kids] == [
        "train.flow", "train.gen_forward", "train.fd", "train.d", "train.d",
        "train.d", "train.g_loss", "train.backward", "train.update"]
    for a, b in zip(kids, kids[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert step["start_ns"] <= kids[0]["start_ns"]
    assert kids[-1]["end_ns"] <= step["end_ns"]
    assert len(by_name(recs, "train.fd")) == 1
    assert len(by_name(recs, "train.d")) == 3
    updates = by_name(recs, "train.update")
    assert len(updates) == 1 + 3 + 1
    assert [tuple(u["item"]) for u in updates] == [
        ("FD",), ("D",), ("D",), ("D",), ("accu", "inpaint", "refine", "pro")]
    for r in recs:   # every span of the step lies in it
        assert step["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= step["end_ns"]
    (flow,) = by_name(recs, "train.flow")
    assert {r["name"] for r in recs if r["parent"] == flow["id"]} == {
        "flow.project", "flow.prepare_faces", "flow.raster", "flow.bc_warp"}
    assert all(r["stream_ms"] >= 0 for r in recs
               if r["name"].startswith("train."))


def test_time_stages_keeps_stage_ms(world, counted):
    """``time_stages`` times the six stages with the profiler off, and
    records nothing; under the profiler it records them too."""
    gen = VideoGenerator(world["pipe"], frame_batch=2, time_stages=True)
    clip = stack_clips([make_clip(world, 0)])
    t0 = time.time_ns()
    gen.generate_batch(clip)
    assert set(gen.stage_ms) == set(STAGES.values())
    assert all(v >= 0.0 for v in gen.stage_ms.values())
    assert profiling.spans(t0) == [] and counted == []
    assert FakeEvent.made > 0           # the stages' events, on the card
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        gen.generate_batch(clip)
    recs = profiling.spans(t0)
    assert set(STAGES) <= {r["name"] for r in recs}
    total = {}
    for r in recs:
        if r["name"] in STAGES:
            key = STAGES[r["name"]]
            total[key] = total.get(key, 0.0) + r["stream_ms"]
    assert total == pytest.approx(gen.stage_ms)


def test_buffer_is_bounded(counted, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span("s", item=i):
                pass
    assert [r["item"] for r in profiling.spans()] == [0, 1, 2]
    assert profiling.dropped() == 2


def test_trace_dir_writes_spans(tmp_path, counted):
    """``--trace-dir``: the block under the profiler, its Chrome trace and
    its spans as JSON lines."""
    d = str(tmp_path / "trace")
    with cli.traced(d):
        with profiling.span("outer", item=("a", "b")):
            with profiling.span("inner", n=7):
                torch.ones(8).sum()
    with cli.traced(""):                 # no directory: nothing traced
        with profiling.span("untraced"):
            pass
    files = set(os.listdir(d)) - {"spans.jsonl"}
    assert files and all(f.endswith(".json") for f in files)
    with open(os.path.join(d, "spans.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["name"] for r in recs] == ["outer", "inner"]
    assert recs[1]["parent"] == recs[0]["id"]
    assert recs[1]["item"] == ["a", "b"] and recs[1]["n"] == 7


def test_train_cli_trace_dir(tmp_path, monkeypatch):
    """``train --trace-dir``: the loop's spans in ``spans.jsonl``, and
    ``losses.jsonl``'s ``seconds`` (``profiling.step_timer``) as before."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("jafpro_tpu_torch.pipeline.init_params_",
                        lambda *a: None)
    d = str(tmp_path / "trace")
    cli.main(["train", "--stage", "1", "--synthetic", "--iters", "2",
              "--device", "cpu", "-n", "tr", "--trace-dir", d])
    with open(os.path.join(d, "spans.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["name"] for r in recs] == ["train.backward",
                                         "train.update"] * 2
    assert all(r["item"] == ["accu"] and r["stream_ms"] >= 0 for r in recs)
    with open(os.path.join("checkpoints", "tr", "losses.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iter"] for r in rows] == [0, 1]
    assert all(r["seconds"] > 0 for r in rows)
