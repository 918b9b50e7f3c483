"""A configuration, a traffic mix, a cell and a per-layer metric are found
by their names: new files and new ``BENCHMARK.json`` entries are enough,
and no file that is there changes. The measurement path refuses to run
without a card, and every result names its device."""

import hashlib
import os
import subprocess
import sys

from benchmark.tests import tiny

READER = '''"""Clips the window served (a test's metric)."""


def read(run):
    return run.readings.get("clips")
'''


def digest(root):
    out = {}
    for dirpath, _, names in os.walk(os.path.join(root, "benchmark")):
        for n in names:
            p = os.path.join(dirpath, n)
            if "__pycache__" not in p:
                with open(p, "rb") as f:
                    out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_cell_config_traffic_and_metric_by_name(tiny_root):
    root = tiny_root
    before = digest(root)
    b = os.path.join(root, "benchmark")
    bench = tiny.harness.load_json(os.path.join(root, "BENCHMARK.json"))
    cfg = tiny.harness.load_json(os.path.join(b, "configs",
                                              "jafpro-gen-bf16.json"))
    tiny.write_json(os.path.join(b, "configs", "extra-gen.json"),
                    dict(cfg, name="extra-gen", compute_dtype="float32"))
    traffic = tiny.harness.load_json(os.path.join(
        b, "traffic", "closed-batch1-refs4.json"))
    traffic["pool"]["seed"] = 9
    tiny.write_json(os.path.join(b, "traffic", "extra-mix.json"), traffic)
    tiny.write_json(os.path.join(b, "workloads", "extra-cell.json"),
                    tiny.harness.load_json(os.path.join(
                        b, "workloads", "gen-serve-batch1.json")))
    with open(os.path.join(b, "metrics", "extra.clips.py"), "w") as f:
        f.write(READER)
    bench["configs"].append({
        "name": "extra-gen", "source": "https://github.com/Larry-u/JAFPro",
        "file": "benchmark/configs/extra-gen.json", "reduced": ["write_jpeg"],
        "why": "a test's configuration"})
    bench["workloads"].append({
        "name": "extra-cell", "config": "extra-gen", "traffic": "extra-mix",
        "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "clips_per_s":
            m["workloads"].append("extra-cell")
    bench["per_layer"].append({
        "name": "extra.clips", "unit": "clips", "better": "higher",
        "source": "program_counter", "layer": "serving loop",
        "moves": "clips_per_s", "workloads": ["extra-cell"]})
    tiny.write_json(os.path.join(root, "BENCHMARK.json"), bench)

    res = tiny.run(root, "extra-cell")
    assert set(res["metrics"]) == {"clips_per_s", "setup_s"}
    assert res["correct"] and res["attempted"] >= 1
    traced = tiny.run(root, "extra-cell", trace=True)
    assert traced["metrics"]["extra.clips"]["value"] >= 1
    assert "serve.compute_share.serve" not in traced["metrics"]
    after = digest(root)
    assert all(after[p] == h for p, h in before.items())
    assert list(traced)[-1] == "checks"
    assert traced["device"]["platform"] == "cpu"


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gen-serve-batch1",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        cwd=tiny.REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def test_fails_in_a_tree_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(os.path.join(tiny.REPO, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    code = ("import runpy, sys; sys.argv = ['run.py', '--workload', "
            "'gen-serve-batch1', '--seed', '5', '--seconds', '1']; "
            "import torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "jafpro_tpu_torch" in out.stderr
