"""Build the port's native sources and load them with ``ctypes``: CUDA
(``*.cu``) with ``nvcc``, host C++ (``*.cc``, the shard reader) with
``g++``.

Each CUDA source under ``csrc/`` exposes a plain ``extern "C"`` entry
point that takes device pointers, sizes and a ``cudaStream_t`` and returns
``cudaGetLastError()``; no PyTorch headers are involved, so a build takes
seconds. Libraries are built at first use into ``_build/`` (git-ignored),
under a name that hashes the source and the flags, and written to a
temporary name that is renamed when complete, so a cut-off build leaves
nothing half-written. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")  # -v: registers / shared memory per kernel
# Sources built with other nvcc flags than NVCC_FLAGS. The rasterizer keeps
# --fmad=false (it is bitwise equal to its plain version); the correlation
# is held to its plain version by a tolerance and keeps fused multiply-adds.
SOURCE_FLAGS = {
    "correlation.cu": tuple(f for f in NVCC_FLAGS if f != "--fmad=false"),
}
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOADED: dict = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = os.path.join(root, "bin", "nvcc") if root else ""
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def find_gxx() -> str:
    """``$CXX``, else ``g++`` on PATH."""
    found = shutil.which(os.environ.get("CXX", "") or "g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the shard reader cannot be built")


def _toolchain(source: str) -> tuple:
    """(compiler finder, flags) for ``csrc/<source>``."""
    if source.endswith(".cu"):
        return find_nvcc, SOURCE_FLAGS.get(source, NVCC_FLAGS)
    if source.endswith(".cc"):
        return find_gxx, GXX_FLAGS
    raise ValueError(f"no compiler for {source}")


def library_path(source: str) -> str:
    """Where the build of ``csrc/<source>`` lives (hash of source + flags)."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_toolchain(source)[1]).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> tuple:
    """Compile ``csrc/<source>`` if its library is missing.

    Returns (library path, seconds spent compiling, compiler output);
    (path, 0.0, "") when the library was already built."""
    path = library_path(source)
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    find, flags = _toolchain(source)
    compiler = find()
    cmd = [compiler, *flags, "-o", tmp, os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed ({proc.returncode}) on "
            f"{source}:\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    lib = _LOADED.get(source)
    if lib is None:
        path = build(source)[0]
        lib = ctypes.CDLL(path)
        _LOADED[source] = lib
    return lib
