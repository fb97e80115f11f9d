"""Times the chol_solve kernel on the GPU: this checkout's source, an
earlier source, edited copies, the plain version and PyTorch's library
calls, all in one process on one card.

    python3 tools/bench_chol_solve.py [--old EARLIER.cu] \
        [--variant COPY.cu ...] [--n 27 62] \
        [--batch 256 1024 8192] [--main-path STEPS] [--out FILE.json]

``--old`` names a source with the first C interface (no batch stride),
for example ``git show <commit>:dm_control_torch/csrc/chol_solve.cu >
_checkout/chol_solve_old.cu``.  ``earlier_wrapper`` and ``--main-path``
are tied to that interface and its Python wrapper.  Each ``--variant`` is
a copy of this checkout's source with an edit to try (another
``kRegWarps``, say), with the present interface.

For every (n, B, type) and every implementation it prints, and with
``--out`` writes as JSON:

- ``graph_us``: microseconds per launch over a CUDA graph of 50 launches
  replayed 20 times (back to back on the device, no host in the way),
  with A warm in L2 (one A) and cold (A rotated over more than 64 MB);
- ``device_us``: device time per call from ``torch.profiler``;
- ``call_us``: CUDA events around one call through the Python wrapper,
  median of 200 (the kernel as the engine calls it, host half included;
  for ``--old`` through a copy of the earlier wrapper);
- ``host_us``: host clock over 2000 calls through the wrapper without a
  synchronise, per call: what a call costs the host (valid where the
  device keeps up, which the other columns show);
- ``bound_us``: the bytes (A and b read once, x written once) over
  3.35 TB/s, or the operations over the float32/float64 rate if larger.

Implementations are timed in turns (old, new, variants, library, then
the same backwards) and both readings are kept.

``--main-path STEPS`` (with ``--old``) then drives humanoid:run at
B = 1024 float32 for STEPS control steps, taking the earlier kernel and
wrapper on even steps and this checkout's on odd ones, and reports the
step times of each: the two share one process, one card and one minute
of the host's mood.  Needs a CUDA device and no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
# H100 SXM, outside the tensor cores
FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
GRAPH_LAUNCHES = 50
COLD_BYTES = 64 << 20


def bound_us(batch, n, dtype):
    size = torch.empty((), dtype=dtype).element_size()
    byte_us = 1e6 * size * batch * (n * n + 2 * n) / HBM_BYTES_PER_S
    flop_us = 1e6 * batch * (n ** 3 / 3 + 2 * n * n) / FLOPS[dtype]
    by = "bytes" if byte_us >= flop_us else "operations"
    return max(byte_us, flop_us), by


def build(source, tag="lib"):
    from dm_control_torch.ops import _cuda_build

    out = os.path.join(tempfile.mkdtemp(prefix="bench_chol_"), f"{tag}.so")
    cmd = [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    return lib, proc.stderr


def raw_launcher(lib, with_stride):
    """launch(a, b, x) on the current stream through the C interface."""
    ptr = ctypes.c_void_p
    fns = {torch.float32: lib.chol_solve_f32,
           torch.float64: lib.chol_solve_f64}
    for fn in fns.values():
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int] + (
            [ctypes.c_longlong] if with_stride else []) + [ptr]
        fn.restype = ctypes.c_int

    def launch(a, b, x):
        batch, n = b.shape
        stride = (n * n,) if with_stride else ()
        err = fns[a.dtype](a.data_ptr(), b.data_ptr(), x.data_ptr(), batch, n,
                           *stride, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return x
    return launch


def earlier_wrapper(launch):
    """The host path of the first version of the wrapper: six checks,
    ``torch.cuda.device``, the output's allocation, and a copy per system
    of a shared (n, n) matrix."""
    def call(a, b):
        if a.ndim == 2:
            a = a.expand(b.shape[0], *a.shape).contiguous()
        if a.device.type != "cuda" or b.device != a.device:
            raise ValueError
        if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
            raise TypeError
        if a.ndim != 3 or a.shape[1] != a.shape[2] or b.shape != a.shape[:2]:
            raise ValueError
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError
        if b.shape[1] < 1 or b.shape[1] > 160:
            raise ValueError
        x = torch.empty_like(b)
        with torch.cuda.device(a.device):
            launch(a, b, x)
        return x
    return call


def kernel_events(prof):
    return [e for e in prof.events()
            if "CUDA" in str(getattr(e, "device_type", ""))]


def device_us(fn, calls=50):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = kernel_events(prof)
    total = sum(getattr(e, "device_time", None) or e.cuda_time for e in ev)
    return total / calls, len(ev) / calls


def call_us(fn, reps=200):
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return float(np.median(times))


def host_us(fn, calls=2000):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def graph_us(launch_k, replays=20):
    """launch_k(k) enqueues the k-th launch on the current stream."""
    graph = torch.cuda.CUDAGraph()
    launch_k(0)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for k in range(GRAPH_LAUNCHES):
            launch_k(k)
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / GRAPH_LAUNCHES)
    return float(np.median(times))


def library_calls():
    def solve(a, b):
        return torch.linalg.solve(a, b)

    def cholesky(a, b):
        L, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return {"torch.linalg.solve": solve,
            "cholesky_ex+cholesky_solve": cholesky}


def measure(impls, n, batch, dtype, rng):
    q = rng.standard_normal((batch, n, n))
    a_np = q @ q.transpose(0, 2, 1) + n * np.eye(n)
    a = torch.as_tensor(a_np, dtype=dtype, device="cuda")
    b = torch.as_tensor(rng.standard_normal((batch, n)), dtype=dtype,
                        device="cuda")
    copies = min(96, COLD_BYTES // (a.numel() * a.element_size()) + 2)
    a_cold = a.unsqueeze(0).repeat(copies, 1, 1, 1)
    x = torch.empty_like(b)
    ref = torch.linalg.solve(a.double(), b.double())
    rows = {}
    order = list(impls) + list(reversed(impls))
    for name in order:
        impl = impls[name]
        row = rows.setdefault(name, {"graph_warm_us": [], "graph_cold_us": [],
                                     "device_us": [], "call_us": [],
                                     "host_us": []})
        if impl.get("raw"):
            raw = impl["raw"]
            row["graph_warm_us"].append(graph_us(lambda k: raw(a, b, x)))
            row["graph_cold_us"].append(
                graph_us(lambda k: raw(a_cold[k % copies], b, x)))
        call = impl["call"]
        dev, kernels = device_us(lambda: call(a, b))
        row["device_us"].append(dev)
        row["device_kernels_per_call"] = kernels
        row["call_us"].append(call_us(lambda: call(a, b)))
        row["host_us"].append(host_us(lambda: call(a, b)))
        row["max_abs_err_vs_float64_solve"] = float(
            (call(a, b).double() - ref).abs().max())
    return rows


def main_path(linalg, old_call, steps, batch=1024):
    """Alternates the earlier and the present kernel step by step."""
    from dm_control_torch import suite

    env = suite.load_batch("humanoid", "run", device="cuda",
                           dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    act_gen = torch.Generator(device="cuda").manual_seed(1)
    state, _ = env.reset(batch, gen)
    new_call = linalg.chol_solve_cuda
    out = {"old": {"step_ms": [], "launches": []},
           "new": {"step_ms": [], "launches": []}}
    try:
        for i in range(-2, steps):  # two warm-up steps
            name = "old" if i % 2 == 0 else "new"
            count = [0]

            def counted(a, b, fn=old_call if name == "old" else new_call):
                count[0] += 1
                return fn(a, b)
            linalg.chol_solve_cuda = counted
            act = 2 * torch.rand(batch, env.model.nu, generator=act_gen,
                                 device="cuda") - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = env.step(state, act)
            torch.cuda.synchronize()
            if i >= 0:
                out[name]["step_ms"].append(1e3 * (time.perf_counter() - t0))
                out[name]["launches"].append(count[0])
    finally:
        linalg.chol_solve_cuda = new_call
    for row in out.values():
        row["median_step_ms"] = float(np.median(row["step_ms"]))
        row["env_steps_per_s"] = 1e3 * batch * len(row["step_ms"]) / sum(
            row["step_ms"])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", help="an earlier chol_solve.cu (no stride)")
    parser.add_argument("--variant", nargs="*", default=[],
                        help="edited copies of this checkout's source")
    parser.add_argument("--n", type=int, nargs="*", default=[27])
    parser.add_argument("--batch", type=int, nargs="*",
                        default=[256, 1024, 8192])
    parser.add_argument("--dtypes", nargs="*", default=["float32", "float64"])
    parser.add_argument("--main-path", type=int, default=0, metavar="STEPS",
                        help="alternate old and new on humanoid:run")
    parser.add_argument("--out", help="also write the JSON to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_chol_solve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dm_control_torch.ops import _cuda_build, linalg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    source = os.path.join(_cuda_build.CSRC, "chol_solve.cu")
    linalg.build()
    out = {"card": card, "torch": torch.__version__, "ptxas": {}, "shapes": []}
    impls = {}
    if args.old:
        lib, report = build(args.old, tag="old")
        out["ptxas"]["old"] = report
        raw = raw_launcher(lib, with_stride=False)
        impls["old"] = {"raw": raw, "call": earlier_wrapper(raw)}
    lib, report = build(source, tag="new")
    out["ptxas"]["new"] = report
    impls["new"] = {"raw": raw_launcher(lib, with_stride=True),
                    "call": linalg.chol_solve_cuda}
    for path in args.variant:
        lib, report = build(path, tag="variant")
        name = os.path.basename(path)
        out["ptxas"][name] = report
        raw = raw_launcher(lib, with_stride=True)
        impls[name] = {
            "raw": raw,
            "call": lambda a, b, raw=raw: raw(a, b, torch.empty_like(b))}
    impls["plain"] = {"call": linalg.chol_solve_reference}
    for name, fn in library_calls().items():
        impls[name] = {"call": fn}

    rng = np.random.default_rng(0)
    for dtype_name in args.dtypes:
        dtype = getattr(torch, dtype_name)
        for n in args.n:
            for batch in args.batch:
                bound, by = bound_us(batch, n, dtype)
                rows = measure(impls, n, batch, dtype, rng)
                shape = {"n": n, "batch": batch, "dtype": dtype_name,
                         "bound_us": bound, "bound_by": by, "impls": rows}
                out["shapes"].append(shape)
                print(json.dumps(shape), flush=True)
    if args.main_path and args.old:
        out["main_path"] = main_path(linalg, impls["old"]["call"],
                                     args.main_path)
        print(json.dumps({"main_path": out["main_path"]}), flush=True)
    print(card)
    for name, report in out["ptxas"].items():
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "stack frame" in line:
                print(f"ptxas[{name}] {line.split(':', 2)[-1].strip()}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
