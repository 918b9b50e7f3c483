"""A copy of the benchmark at a size a CPU test holds: the same files,
drivers and readers, with each configuration cut to 64^2 images, parts of
16 px, 2 references, 4 frames and a 38-vertex sphere, and each pool to a
few clips or records. ``run`` drives a cell of it on the CPU."""

from __future__ import annotations

import io
import json
import os
import shutil
import time

import torch

from benchmark import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL = {"image_size": 64, "part_size": 16, "face_crop_size": 16,
         "num_verts": 38, "num_faces": 72, "num_frames": 4,
         "maximum_ref_frames": 2}


def make_root(tmp: str) -> str:
    """A checkout-like root under ``tmp``: ``BENCHMARK.json`` and
    ``benchmark/`` with the small configurations and pools."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        cfg = dict(harness.load_json(path), **SMALL)
        write_json(path, cfg)
    tdir = os.path.join(root, "benchmark", "traffic")
    for name in os.listdir(tdir):
        t = harness.load_json(os.path.join(tdir, name))
        pool = t["pool"]
        if "records" in pool:
            pool["records"] = 8
        else:
            pool.update(clips=3, frames=SMALL["num_frames"], refs=sorted(
                {min(r, SMALL["maximum_ref_frames"]) for r in pool["refs"]}))
        write_json(os.path.join(tdir, name), t)
    return root


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(root: str, cell: str, seed: int = 2 ** 31 + 5, seconds: float = 1.0,
        trace: bool = False) -> dict:
    torch.manual_seed(0)
    return harness.run_cell(root, cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            out=io.StringIO(), err=io.StringIO())
