"""Nothing under ``benchmark/`` imports JAX, flax or the JAX package, and
the reference imports nothing of the program: top-level module names are
compared whole, so ``jafpro_tpu_torch`` is not taken for ``jafpro_tpu``."""

import ast
import os
import re
import subprocess
import sys

from benchmark.tests.tiny import REPO

BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|jafpro_tpu)(\.|$)")
PORT = re.compile(r"^jafpro_tpu_torch(\.|$)")


def py_files(d):
    for dirpath, _, names in os.walk(d):
        yield from (os.path.join(dirpath, n) for n in sorted(names)
                    if n.endswith(".py"))


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, (path, "relative import")
            yield node.module


def test_pattern_compares_whole_names():
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "jafpro_tpu",
                 "jafpro_tpu.cli"):
        assert FORBIDDEN.match(name), name
    for name in ("jafpro_tpu_torch", "jafpro_tpu_torch.cli", "jaxtyping",
                 "benchmark.reference"):
        assert not FORBIDDEN.match(name), name


def test_benchmark_imports_no_jax():
    files = list(py_files(BENCH))
    assert len(files) > 20
    for path in files:
        bad = [n for n in imported(path) if FORBIDDEN.match(n)]
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    files = list(py_files(os.path.join(BENCH, "reference")))
    assert len(files) >= 6
    for path in files:
        names = list(imported(path))
        bad = [n for n in names if PORT.match(n) or FORBIDDEN.match(n)]
        assert not bad, (path, bad)
        own = [n for n in names if n.startswith("benchmark")
               and not n.startswith("benchmark.reference")]
        assert not own, (path, own)


def test_harness_loads_no_jax():
    """Importing the harness and every driver and reader loads no JAX."""
    code = f"""
import os, sys
sys.path.insert(0, {REPO!r})
from benchmark import harness
d = os.path.join({BENCH!r})
for sub in ("drivers", "metrics"):
    for n in sorted(os.listdir(os.path.join(d, sub))):
        if n.endswith(".py"):
            harness.load_module(os.path.join(d, sub, n))
import benchmark.calibrate, benchmark.run
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
