"""Tracing and timing helpers: ``torch.profiler`` traces and timing with
the device synchronised (counterpart of
``dm_control_tpu/utils/profiling.py``).

One idiom for scripts and benchmarks:

    with profiling.trace("/tmp/tb"):           # Chrome/TensorBoard trace
        run()

    stats = profiling.time_jitted(fn, *args)   # median ms a call

    with profiling.annotate("rollout"):        # named region in the trace
        rollout()

Timings wait for the card: where an output of the timed call is a CUDA
tensor, ``torch.cuda.synchronize()`` runs before the clock is read, since
PyTorch returns before the device finishes.

Reference: dm_control/scripts/print_profile.py:1-4 (host profile dump),
dm_control/scripts/rl/ppo/ppo.py:119-160 (scalar/time logging).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Captures a ``torch.profiler`` trace of the host and, where CUDA is
    available, the card into ``logdir``: a Chrome trace
    (``<logdir>/trace_<pid>_<ns>.json``) that TensorBoard's profiler
    plugin and Perfetto read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region that shows up on the timeline inside a trace."""
    return torch.profiler.record_function(name)


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _sync(tree: Any) -> None:
    """Waits for the card if any tensor of ``tree`` lies on it."""
    if any(t.is_cuda for t in _leaves(tree)):
        torch.cuda.synchronize()


def time_jitted(fn: Callable, *args, n_warmup: int = 1, n_iters: int = 10,
                **kwargs) -> Dict[str, float]:
    """Times ``fn(*args, **kwargs)`` with the device synchronised.

    Returns ``compile_s`` (the first call: PyTorch compiles nothing ahead,
    so it is the first call's time, a kernel's first-use build included),
    and ``median_ms``, ``mean_ms``, ``min_ms`` of ``n_iters`` later calls,
    and ``n_iters``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, n_warmup - 1)):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    median = times[n // 2] if n % 2 else 0.5 * (times[n // 2 - 1]
                                                + times[n // 2])
    return {
        "compile_s": compile_s,
        "median_ms": median * 1e3,
        "mean_ms": sum(times) / n * 1e3,
        "min_ms": times[0] * 1e3,
        "n_iters": float(n),
    }


class StepTimer:
    """Accumulates wall time by phase across a training loop (the
    reference PPO's time/rollout against time/update split,
    ppo.py:119-160):

        timer = StepTimer()
        with timer.phase("rollout"):
            ...
        with timer.phase("update", sync=loss):
            ...
        timer.summary()  # {"rollout_s": ..., "rollout_mean_ms": ...}

    ``sync`` names tensors whose device is synchronised before the phase's
    clock stops."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._n[name] = self._n.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        out = {}
        for k, v in self._acc.items():
            out[f"{k}_s"] = v
            out[f"{k}_mean_ms"] = v / max(1, self._n[k]) * 1e3
        return out

    def reset(self) -> None:
        self._acc.clear()
        self._n.clear()


def compiled_stats(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """The floating-point operations of one call of ``fn``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` as ``flops``.  The JAX
    version's ``bytes_accessed`` and ``transcendentals`` have no counter in
    PyTorch and are left out."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}
