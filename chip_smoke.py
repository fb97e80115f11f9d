"""Smoke test of the PyTorch port (dm_control_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version (sizes on both sides of every boundary
of the launcher's rule, both types, a shared matrix, a matrix given by its
lower triangle alone, a non-SPD system),
times it beside its bound, the plain version and PyTorch's library calls
for the same function, checks one float64 control step of
humanoid:run against the JAX package's golden result, drives the main
path (``suite.load_batch("humanoid", "run")`` -> ``BatchEnv.reset`` and
``BatchEnv.step`` at B = 1024, float32) and checks that every dense solve
on it went through the kernel, then compares a short rollout with and
without the kernel.  Each phase prints one line; any failure exits with a
non-zero code.  The last line is a JSON object naming the device.  Needs
one CUDA device; exits with code 1 and prints no result without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_humanoid_golden_f64.npz")
STATE_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time")
MAIN_BATCH = 1024
MAIN_STEPS = 8
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


KERNEL_NS = (1, 2, 7, 27, 31, 32, 33, 40, 62, 63, 64, 65, 79, 160)
KERNEL_BS = (1, 1001, 1024)  # 1001 fills no block of 4 warps evenly
SHARED_NS = (27, 32, 33, 64, 65)
LOWER_NS = (27, 32, 33, 64, 65)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FLOAT32_FLOPS = 67e12      # H100 SXM, outside the tensor cores


def spd(gen, b, n, dtype):
    q = torch.randn(b, n, n, generator=gen, dtype=torch.float64,
                    device="cuda")
    a = q @ q.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64,
                                                device="cuda")
    return a.to(dtype)


def randn(gen, shape, dtype):
    return torch.randn(*shape, generator=gen, dtype=torch.float64,
                       device="cuda").to(dtype)


def time_ms(fn, reps=30):
    """Median milliseconds per call over ``reps`` CUDA-event timings."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls=50):
    """Device milliseconds per call from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if "CUDA" in str(getattr(e, "device_type", ""))]
    total_us = sum(getattr(e, "device_time", None) or e.cuda_time
                   for e in events)
    check(total_us > 0, "torch.profiler saw no kernel on the device")
    return total_us / 1e3 / calls


def check_close(x, ref, dtype, what):
    err = (x - ref).abs() - TOL[dtype] * ref.abs()
    check(bool(torch.isfinite(x).all()), f"non-finite x at {what}")
    check(bool((err <= TOL[dtype]).all()),
          f"kernel != plain at {what}: max |dx| "
          f"{float((x - ref).abs().max()):.3e}")
    return float((x - ref).abs().max())


def phase_kernel(linalg):
    """Kernel against plain version over sizes on both sides of every
    boundary of the launcher's rule, both types, a shared matrix, a matrix
    given by its lower triangle alone and one non-SPD system; then the main-path shape's error, times and bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        for n in KERNEL_NS:
            a_all = spd(gen, max(KERNEL_BS), n, dtype)
            rhs_all = randn(gen, (max(KERNEL_BS), n), dtype)
            for b in KERNEL_BS:
                a, rhs = a_all[:b], rhs_all[:b]
                x = linalg.chol_solve_cuda(a, rhs)
                torch.cuda.synchronize()
                worst[dtype] = max(worst[dtype], check_close(
                    x, linalg.chol_solve_reference(a, rhs), dtype,
                    f"n={n} B={b} {dtype}"))
        # one (n, n) matrix shared by the batch: read with a batch stride
        # of 0, directly and as an expanded view through the dispatcher
        for n in SHARED_NS:
            a = spd(gen, 1, n, dtype)[0]
            rhs = randn(gen, (1001, n), dtype)
            ref = linalg.chol_solve_reference(a.expand(1001, n, n), rhs)
            worst[dtype] = max(worst[dtype], check_close(
                linalg.chol_solve_cuda(a, rhs), ref, dtype,
                f"shared matrix n={n} {dtype}"))
            check_close(linalg.chol_solve(a.expand(1001, n, n), rhs), ref,
                        dtype, f"expanded shared matrix n={n} {dtype}")
        # only the lower triangle is the input, as for the plain version:
        # what stands above the diagonal must not reach x
        for n in LOWER_NS:
            a = spd(gen, 1001, n, dtype)
            rhs = randn(gen, (1001, n), dtype)
            ref = linalg.chol_solve_reference(a, rhs)
            junk = a.tril() + randn(gen, (1001, n, n), dtype).triu(1)
            check_close(linalg.chol_solve_reference(junk, rhs), ref, dtype,
                        f"plain version, lower triangle only n={n} {dtype}")
            worst[dtype] = max(worst[dtype], check_close(
                linalg.chol_solve_cuda(junk, rhs), ref, dtype,
                f"lower triangle only n={n} {dtype}"))
        # one system that is not SPD inside a batch: NaN in that row only
        for n in (27, 62, 79):
            a = spd(gen, 1001, n, dtype)
            a[17] = -a[17]
            rhs = torch.ones(1001, n, dtype=dtype, device="cuda")
            x = linalg.chol_solve_cuda(a, rhs)
            ref = linalg.chol_solve_reference(a, rhs)
            torch.cuda.synchronize()
            nan_rows = torch.isnan(x).any(-1).nonzero().flatten().tolist()
            check(nan_rows == [17] and bool(torch.isnan(x[17]).all()),
                  f"non-SPD system n={n} {dtype}: NaN rows {nan_rows}, "
                  f"expected [17]")
            check(torch.isnan(ref[17]).all(),
                  "plain version lost the NaN row")
            keep = torch.arange(1001, device="cuda") != 17
            check(bool(torch.allclose(x[keep], ref[keep], rtol=TOL[dtype],
                                      atol=TOL[dtype])),
                  f"non-SPD system disturbed other rows (n={n} {dtype})")

    # the main path's shape; A stays warm in L2 between calls, as on the
    # main path, where the product that writes H runs just before
    n = 27
    a = spd(gen, MAIN_BATCH, n, torch.float32)
    rhs = randn(gen, (MAIN_BATCH, n), torch.float32)
    err = float((linalg.chol_solve_cuda(a, rhs)
                 - linalg.chol_solve_reference(a, rhs)).abs().max())

    def library(a, rhs):
        return torch.linalg.solve(a, rhs)

    def library_cholesky(a, rhs):
        factor, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(rhs.unsqueeze(-1), factor).squeeze(-1)

    lib_err = float((library(a, rhs)
                     - linalg.chol_solve_reference(a, rhs)).abs().max())
    check(lib_err <= TOL[torch.float32], f"library call != plain: {lib_err}")
    fns = {"ms": linalg.chol_solve_cuda, "plain_ms":
           linalg.chol_solve_reference, "library_ms": library,
           "library_cholesky_ms": library_cholesky}
    runs = {k: [] for k in fns}
    for order in (list(fns), list(reversed(fns))):  # in turns
        for k in order:
            runs[k].append(time_ms(lambda: fns[k](a, rhs)))
    dev_ms = device_ms(lambda: linalg.chol_solve_cuda(a, rhs))
    # the bound counts the dense a at the rate of device memory; the lower
    # triangle, which is all the kernel reads, is fewer bytes, and an a that
    # is warm in L2 comes at a higher rate: the true floor is lower
    byte_ms = 1e3 * 4 * MAIN_BATCH * (n * n + 2 * n) / HBM_BYTES_PER_S
    triangle_ms = (1e3 * 4 * MAIN_BATCH * (n * (n + 1) // 2 + 2 * n)
                   / HBM_BYTES_PER_S)
    flop_ms = 1e3 * MAIN_BATCH * (n ** 3 / 3 + 2 * n * n) / FLOAT32_FLOPS
    out = {k: min(v) for k, v in runs.items()}
    out.update(max_abs_err=err, device_ms=dev_ms,
               bound_ms=max(byte_ms, flop_ms), triangle_bound_ms=triangle_ms,
               bound_by="bytes" if byte_ms >= flop_ms else "operations",
               worst_f32=worst[torch.float32],
               worst_f64=worst[torch.float64], runs=runs)
    return out


def phase_golden(suite):
    """One float64 control step from the golden's start states (after a
    reset, and on the floor with contacts active) against JAX."""
    g = np.load(GOLDEN, allow_pickle=False)
    env = suite.load_batch("humanoid", "run", device="cuda",
                           dtype=torch.float64, autoreset=False)
    errs = {}
    for p in ("reset", "contact"):
        state = env.from_state(
            *(torch.as_tensor(g[f"{p}_{f}"], device="cuda")
              for f in STATE_FIELDS),
            generator=torch.Generator(device="cuda").manual_seed(0))
        state, ts = env.step(state, torch.as_tensor(g[f"{p}_actions"],
                                                    device="cuda"))
        errs.update({f"{p}_{f}": float(np.abs(
            getattr(state.data, f).cpu().numpy() - g[f"{p}_step_{f}"]).max())
            for f in STATE_FIELDS})
        errs.update({f"{p}_obs_{k}": float(np.abs(
            v.cpu().numpy() - g[f"{p}_obs_{k}"]).max())
            for k, v in ts.observation.items()})
        errs[f"{p}_reward"] = float(np.abs(ts.reward.cpu().numpy()
                                           - g[f"{p}_reward"]).max())
        check(np.array_equal(ts.step_type.cpu().numpy(),
                             g[f"{p}_step_type"]),
              f"golden step_type mismatch ({p})")
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-8, f"golden mismatch: {worst} {errs[worst]:.3e}")
    return errs[worst], worst


def phase_main(suite, linalg):
    env = suite.load_batch("humanoid", "run", device="cuda",
                           dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    act_gen = torch.Generator(device="cuda").manual_seed(1)
    nu = env.model.nu

    def actions():
        return 2.0 * torch.rand(MAIN_BATCH, nu, generator=act_gen,
                                device="cuda") - 1.0

    linalg.chol_solve.launches = 0
    state, ts = env.reset(MAIN_BATCH, gen)
    torch.cuda.synchronize()
    step_times = []
    diverged = 0
    rewards = []
    for i in range(MAIN_STEPS):
        t0 = time.perf_counter()
        state, ts = env.step(state, actions())
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        diverged += int(((ts.step_type == 2) & (ts.discount == 0)).sum())
        rewards.append(ts.reward)
        check(all(bool(torch.isfinite(v).all())
                  for v in ts.observation.values()),
              f"non-finite observation at step {i}")
    launches = linalg.chol_solve.launches
    check(all(v.device.type == "cuda" for v in ts.observation.values()),
          "observation left the card")
    r = torch.stack(rewards)
    check(bool(torch.isfinite(r).all()), "non-finite reward")
    check(bool(((r >= 0) & (r <= 1)).all()), "reward outside [0, 1]")
    substeps = MAIN_STEPS * env.n_sub_steps
    check(launches >= 3 * substeps,
          f"chol_solve launched {launches} times in {substeps} substeps "
          f"(expected >= 3 per substep)")
    warm = step_times[1:]  # first step is the warm-up
    sps = MAIN_BATCH * len(warm) / sum(warm)
    return dict(launches=launches, substeps=substeps, env_steps_per_s=sps,
                diverged_share=diverged / (MAIN_BATCH * MAIN_STEPS),
                step_ms=[1e3 * t for t in step_times],
                mean_reward=float(r.mean()))


def phase_selfcheck(suite, linalg, engine, make_data, batch=256, steps=5):
    env = suite.load_batch("humanoid", "run", device="cuda",
                           dtype=torch.float32)
    m = env.model
    d0 = make_data(m, batch)
    d0 = d0.replace(qvel=torch.full_like(d0.qvel, 0.05))

    def run():
        d = d0
        for _ in range(steps):
            d = engine.step(m, d)
        return d.qpos

    q_kernel = run()
    with linalg.reference_solves():
        q_plain = run()
    dq = float((q_kernel - q_plain).abs().max())
    check(dq <= 1e-4, f"selfcheck max |dqpos| {dq:.3e} > 1e-4")
    return dq


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dm_control_torch import suite
    from dm_control_torch.ops import _cuda_build, linalg
    from dm_control_torch.physics import engine
    from dm_control_torch.physics.model import make_data

    card = card_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    linalg.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.split(":", 2)[-1].strip() for ln in _cuda_build.ptxas_report
             .get("chol_solve.cu", "").splitlines() if "registers" in ln]
    print(f"phase 2 build: chol_solve.cu in {build_s:.2f} s (nvcc "
          f"{_cuda_build.build_seconds.get('chol_solve.cu', 0.0):.2f} s); "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

    k = phase_kernel(linalg)
    print(f"phase 3 kernel vs plain: ok over n in {KERNEL_NS}, B in "
          f"{KERNEL_BS}, shared matrix (stride 0) n in {SHARED_NS}, lower triangle only n "
          f"in {LOWER_NS}, max "
          f"|dx| f32 {k['worst_f32']:.3e} f64 {k['worst_f64']:.3e}, non-SPD "
          f"row NaN only; B={MAIN_BATCH} n=27 f32 A warm in L2: kernel "
          f"{k['ms']:.4f} ms per call (device {k['device_ms']:.4f} ms by "
          f"torch.profiler), bound {k['bound_ms']:.5f} ms by "
          f"{k['bound_by']} ({k['triangle_bound_ms']:.5f} ms for the lower "
          f"triangle alone), plain {k['plain_ms']:.4f} ms, "
          f"torch.linalg.solve {k['library_ms']:.4f} ms, cholesky_ex + "
          f"cholesky_solve {k['library_cholesky_ms']:.4f} ms (runs "
          + " ".join(f"{name} {v[0]:.4f}/{v[1]:.4f}"
                     for name, v in k["runs"].items())
          + f") | {card}", flush=True)

    gerr, gworst = phase_golden(suite)
    print(f"phase 4 golden: float64 humanoid:run step on the card vs JAX "
          f"golden (reset and contact states), max |d| {gerr:.3e} "
          f"({gworst}) <= 1e-8", flush=True)

    main_run = phase_main(suite, linalg)
    print(f"phase 5 main path: humanoid:run B={MAIN_BATCH} float32, "
          f"{MAIN_STEPS} steps ({main_run['substeps']} substeps), "
          f"chol_solve launches {main_run['launches']}, "
          f"{main_run['env_steps_per_s']:.1f} env-steps/s after warm-up, "
          f"diverged share {main_run['diverged_share']:.4f}, mean reward "
          f"{main_run['mean_reward']:.4f}, step ms "
          f"{[round(t, 1) for t in main_run['step_ms']]} | {card}",
          flush=True)

    dq = phase_selfcheck(suite, linalg, engine, make_data)
    print(f"phase 6 selfcheck: humanoid B=256, 5 engine.steps, kernel vs "
          f"plain max |dqpos| {dq:.3e} <= 1e-4", flush=True)

    print(json.dumps({"kernels": [{
        "name": "chol_solve", "route": "cuda",
        "source": "dm_control_torch/csrc/chol_solve.cu",
        "replaces": "dm_control_tpu/ops/linalg.py:69",
        "launches": main_run["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "library_call": "torch.linalg.solve",
        "library_cholesky_ms": k["library_cholesky_ms"],
        "device_ms": k["device_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(2)
