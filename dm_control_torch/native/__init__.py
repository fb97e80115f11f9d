"""The native batch loader of behaviour-cloning training (counterpart of
``dm_control_tpu/native/__init__.py``).

``trajloader.cc`` is a threaded block gather and a double-buffered
prefetch ring over a dataset held in host memory: the next
[batch, block, dim] pair is assembled by C++ threads while the card
consumes the current one (the reference's torch DataLoader worker
processes, scripts/dataset.py + trainer.py).  The port keeps its own copy
of the source.  It is built with g++ at first use into
``dm_control_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, and loaded with ctypes.  Where it cannot be
built, ``gather_blocks`` and ``PrefetchLoader`` raise: there is no quiet
numpy fallback (the JAX trainer falls back; ROADMAP C).
"""

from __future__ import annotations

import bisect
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "trajloader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_LOADED: dict = {}
#: g++ seconds of the build made in this process, if one was made
build_seconds: dict = {}


def library_path() -> str:
    """Where the build of this exact source and these flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libtrajloader_{digest.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found on PATH: dm_control_torch's native batch loader "
            "(native/trajloader.cc) is built with g++ at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *FLAGS, SOURCE, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on trajloader.cc (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    build_seconds["trajloader.cc"] = time.perf_counter() - t0
    os.replace(tmp, so_path)


def load_library() -> ctypes.CDLL:
    """The ctypes handle of the loader, built first if no build of this
    source exists; raises RuntimeError naming g++ where it cannot be
    built."""
    so_path = library_path()
    with _lock:
        lib = _LOADED.get(so_path)
        if lib is not None:
            return lib
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tl_gather.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i64p, ctypes.c_int, ctypes.c_int, f32p, f32p]
        lib.tl_gather.restype = None
        lib.tl_create.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, i64p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int]
        lib.tl_create.restype = ctypes.c_void_p
        lib.tl_next.argtypes = [ctypes.c_void_p, f32p, f32p]
        lib.tl_next.restype = None
        lib.tl_destroy.argtypes = [ctypes.c_void_p]
        lib.tl_destroy.restype = None
        _LOADED[so_path] = lib
        return lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check_starts(starts, block, n):
    """The C++ side copies with raw memcpy: bounds are checked here, so
    malformed start rows raise instead of reading past the arrays."""
    if len(starts) and (starts.min() < 0 or starts.max() + block > n):
        raise IndexError(
            f"block start out of range: starts in "
            f"[{starts.min()}, {starts.max()}], block={block}, rows={n}")


def gather_blocks(obs, act, starts, block, n_threads=4):
    """Threaded gather of [batch, block, dim] float32 blocks from explicit
    start rows."""
    lib = load_library()
    obs = np.ascontiguousarray(obs, np.float32)
    act = np.ascontiguousarray(act, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    _check_starts(starts, block, min(obs.shape[0], act.shape[0]))
    batch = len(starts)
    out_obs = np.empty((batch, block, obs.shape[1]), np.float32)
    out_act = np.empty((batch, block, act.shape[1]), np.float32)
    lib.tl_gather(_f32p(obs), _f32p(act), obs.shape[0], obs.shape[1],
                  act.shape[1], block, _i64p(starts), batch, n_threads,
                  _f32p(out_obs), _f32p(out_act))
    return out_obs, out_act


class PrefetchLoader:
    """A background-prefetching stream of batches over a
    ``TrajectoryDataset``: the C++ worker assembles the next
    [batch, block, dim] pair while the previous one is consumed; ``next()``
    returns numpy arrays ready to copy to the card.  The blocks' starts are
    drawn by the loader's xorshift128+ seeded ``seed``: the JAX package's
    loader gives the same batches at the same seed."""

    def __init__(self, dataset, batch_size, seed=0, n_threads=4):
        lib = self._lib = load_library()
        self.block = dataset.block_size
        self.batch = batch_size
        # the buffers outlive the C++ loader: references kept here
        self._obs = np.ascontiguousarray(dataset.observations, np.float32)
        self._act = np.ascontiguousarray(dataset.actions, np.float32)
        starts = np.array([
            i + dataset.logical_offset[
                bisect.bisect_left(dataset.logical_index, i)]
            for i in range(len(dataset))], np.int64)
        self._starts = np.ascontiguousarray(starts)
        _check_starts(self._starts, self.block,
                      min(self._obs.shape[0], self._act.shape[0]))
        self._h = lib.tl_create(
            _f32p(self._obs), _f32p(self._act), self._obs.shape[0],
            self._obs.shape[1], self._act.shape[1], _i64p(self._starts),
            len(self._starts), self.block, self.batch,
            ctypes.c_uint64(seed), n_threads)

    def next(self):
        out_obs = np.empty((self.batch, self.block, self._obs.shape[1]),
                           np.float32)
        out_act = np.empty((self.batch, self.block, self._act.shape[1]),
                           np.float32)
        self._lib.tl_next(self._h, _f32p(out_obs), _f32p(out_act))
        return out_obs, out_act

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tl_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
