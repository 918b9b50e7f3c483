"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` exposes a plain ``extern "C"`` entry point that
takes device pointers, sizes and a ``cudaStream_t`` and returns
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


def library_path(source: str) -> str:
    """Where the build of ``csrc/<source>`` lives (hash of source + flags)."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
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
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
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
