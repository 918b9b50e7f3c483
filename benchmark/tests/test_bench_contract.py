"""``BENCHMARK.json`` keeps the benchmark's format, and every name in it
finds its files: configuration, workload, traffic, driver and reader."""

import json
import os
import re

import pytest

from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and ".." not in p.split("/")
        assert not p.startswith("/")
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24   # the most cells a later check holds
    assert 2 + 14 * cells * (bench["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not re.search(r"(_dim|_rank|size|width|heads)$", k), k


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        d = os.path.join(REPO, "benchmark")
        with open(os.path.join(d, "workloads", w["name"] + ".json")) as f:
            spec = json.load(f)
        assert os.path.exists(os.path.join(d, "drivers",
                                           spec["driver"] + ".py"))
        assert os.path.exists(os.path.join(d, "traffic",
                                           w["traffic"] + ".json"))


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    names = set()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]].get("workloads", cells), (m, c)
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for c in m.get("workloads", []):
            assert c in cells
    for c in cells:     # setup_s, one more end-to-end, one per-layer
        mine = [m for m in bench["end_to_end"]
                if c in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(c in m.get("workloads", cells)
                   for m in bench["per_layer"])
