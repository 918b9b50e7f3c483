"""The port runs where JAX is not installed: no module of
``jafpro_tpu_torch``, nor ``chip_smoke.py``, imports ``jax``, ``flax`` or
``jafpro_tpu``; of the files added beside the JAX package only
``tools/export_jax_params.py`` does, and nothing in the port imports it;
and its entry points never fall back to the CPU."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import jafpro_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(jafpro_tpu_torch.__file__)
FORBIDDEN = re.compile(r"^(jax|flax|jafpro_tpu)(\.|$)")


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG_DIR], "jafpro_tpu_torch."))


def source_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_pattern():
    for name in ("jax", "jax.numpy", "flax.linen", "jafpro_tpu",
                 "jafpro_tpu.ops.sampling"):
        assert FORBIDDEN.match(name), name
    for name in ("jafpro_tpu_torch", "jafpro_tpu_torch.ops", "jaxlib_x",
                 "torch", "numpy"):
        assert not FORBIDDEN.match(name), name


def test_sources_import_no_jax():
    files = source_files()
    assert len(files) > 15
    for path in files:
        bad = [n for n in imported_names(path) if FORBIDDEN.match(n)]
        assert not bad, (path, bad)


def test_only_the_export_tool_imports_jax():
    """``tools/export_jax_params.py`` (run where JAX is installed) is the one
    non-test file beside the JAX package that imports it; no port module
    and not ``chip_smoke.py`` imports that tool."""
    tool = os.path.join(ROOT, "tools", "export_jax_params.py")
    importers = [p for p in source_files() + [tool]
                 if any(FORBIDDEN.match(n) for n in imported_names(p))]
    assert importers == [tool]
    for path in source_files():
        bad = [n for n in imported_names(path)
               if re.match(r"^(tools|export_jax_params)(\.|$)", n)]
        assert not bad, (path, bad)


def test_rank_helpers_import_no_jax():
    """The data-parallel tests' ranks are fresh interpreters that import
    ``tests/_torch_parallel_helpers.py``: it imports neither JAX nor a test
    module."""
    path = os.path.join(ROOT, "tests", "_torch_parallel_helpers.py")
    names = list(imported_names(path))
    assert "jafpro_tpu_torch.parallel" in names
    bad = [n for n in names
           if FORBIDDEN.match(n) or n.split(".")[0].startswith(("test_",
                                                                  "_torch_"))]
    assert not bad, bad


def test_flownet2_reference_imports_nothing_of_the_port():
    """The benchmark's FlowNet2 reference imports neither the port nor
    JAX, and its trainer turns TF32 off."""
    path = os.path.join(ROOT, "benchmark", "reference", "flownet2.py")
    names = list(imported_names(path))
    bad = [n for n in names if FORBIDDEN.match(n)
           or re.match(r"^jafpro_tpu_torch(\.|$)", n)]
    assert not bad, bad
    sys.path.insert(0, ROOT)
    from benchmark.reference import flownet2

    cfg = {"optimizer_lr": 1e-3, "optimizer_betas": [0.9, 0.999],
           "optimizer_eps": 1e-8, "optimizer_weight_decay": 0.0}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 \
        = True
    flownet2.Trainer(flownet2.FlowNetFusion(), cfg)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("package", ["", "geometry", "ops", "train",
                                     "parallel"])
def test_package_exports_match_jax(package):
    """Each ``__init__.py`` of the port exports what the JAX package's
    does (read from its source; the JAX package is not imported)."""
    import importlib

    jax_init = os.path.join(ROOT, "jafpro_tpu", package, "__init__.py")
    with open(jax_init) as f:
        tree = ast.parse(f.read(), jax_init)
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert names
    port = importlib.import_module(
        "jafpro_tpu_torch" + (f".{package}" if package else ""))
    assert sorted(n for n in names if not hasattr(port, n)) == []


def test_modules_import_with_jax_blocked():
    """Import every port module and chip_smoke.py in a fresh interpreter in
    which ``import jax`` / ``import jafpro_tpu`` fail."""
    mods = port_modules()
    assert {"jafpro_tpu_torch.geometry.rasterizer",
            "jafpro_tpu_torch.parallel",
            "jafpro_tpu_torch.parallel.mesh",
            "jafpro_tpu_torch.ops.correlation",
            "jafpro_tpu_torch.models.flownet",
            "jafpro_tpu_torch.train.flow_harness",
            "jafpro_tpu_torch.data.flow_datasets",
            "jafpro_tpu_torch.data.shardio",
            "jafpro_tpu_torch.torch_compat"} <= set(mods)
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'jafpro_tpu'):",
        "    sys.modules[name] = None",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "bad = [m for m in sys.modules if m.split('.')[0] in",
        "       ('jax', 'flax', 'jafpro_tpu') and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """With no CUDA, an entry point called without ``device`` raises
    instead of running on the CPU."""
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.device import resolve_device
    from jafpro_tpu_torch.pipeline import JAFProPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    cfg = Config(image_size=32, part_size=16, num_parts=2, num_faces=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JAFProPipeline(cfg)
    from jafpro_tpu_torch.train.flow_harness import make_flow_train_step

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_flow_train_step("c")
    assert resolve_device("cpu").type == "cpu"
