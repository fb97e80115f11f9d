"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each source under ``dm_control_torch/csrc/`` exposes a plain C interface,
so it compiles in seconds without PyTorch's headers.  The shared library
goes to ``dm_control_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads from the previous build.  Nothing here runs at import
time: a library is built on the first call that needs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC")

_LOADED: dict = {}
#: per source built in this process: nvcc seconds and its ptxas report
build_seconds: dict = {}
ptxas_report: dict = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of dm_control_torch are built on "
            "first use and need the CUDA toolkit")
    return found


def load_library(source: str) -> ctypes.CDLL:
    """Returns the ctypes handle of ``csrc/<source>``, building it first
    if no build of this exact source exists."""
    lib = _LOADED.get(source)
    if lib is not None:
        return lib
    src_path = os.path.join(CSRC, source)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    so_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src_path]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        ptxas_report[source] = proc.stderr
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    _LOADED[source] = lib
    return lib
