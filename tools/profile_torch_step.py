"""Where the time of one humanoid:run control step goes on the GPU.

    python3 tools/profile_torch_step.py [--batch 1024] [--out FILE.json]

Runs the port (``dm_control_torch``) at float32 on one CUDA device and
prints (and with ``--out`` also writes) one JSON object:

- one profiled ``BatchEnv.step``: device kernels per step, device busy
  time and idle share (``torch.profiler``), the top operators by device
  and by host time;
- host milliseconds per pipeline stage over the 5 substeps of one step,
  with a ``torch.cuda.synchronize()`` after each stage, and the Newton
  iterations per substep (max and mean over the batch);
- the chol_solve kernel against its plain version at (B, 27) float32:
  device time per call from the profiler, and CUDA-event time per call
  over 200 back-to-back calls.

Needs a CUDA device and no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernel_events(prof):
    return [e for e in prof.events()
            if "CUDA" in str(getattr(e, "device_type", ""))]


def _device_us(events):
    return sum(getattr(e, "device_time", None) or e.cuda_time
               for e in events)


def _self_device_us(avg):
    return getattr(avg, "self_device_time_total", None) \
        or getattr(avg, "self_cuda_time_total", 0.0)


def profile_step(env, state, act):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = env.step(state, act())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernel_events(prof)
    busy_us = _device_us(kernels)
    avgs = prof.key_averages()
    by_dev = sorted(avgs, key=lambda e: -_self_device_us(e))[:15]
    by_cpu = sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:15]
    return state, {
        "profiled_step_wall_ms": wall * 1e3,
        "device_kernels_per_step": len(kernels),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "top_device_ms": [(e.key, _self_device_us(e) / 1e3, e.count)
                          for e in by_dev],
        "top_cpu_ms": [(e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in by_cpu],
    }


def stage_times(env, state, act):
    from dm_control_torch.physics import (
        actuation, collision, constraints, engine, inertia, kinematics,
        sensors, solver)

    m = env.model
    stages = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t) * 1e3
        return out

    niters = []
    d = env.task.before_step(m, env._unstrip(state.data), act())
    for _ in range(env.n_sub_steps):
        d = timed("kinematics", kinematics.kinematics, m, d)
        d = timed("com_pos", kinematics.com_pos, m, d)
        d = timed("crb", inertia.crb, m, d)
        d = timed("collision", collision.collision, m, d)
        d = timed("transmission", actuation.transmission, m, d)
        d = timed("sensor_pos", sensors.sensor_pos, m, d)
        d = timed("fwd_velocity", engine.fwd_velocity, m, d)
        d = timed("sensor_vel", sensors.sensor_vel, m, d)
        d = timed("fwd_actuation", engine.fwd_actuation, m, d)
        d = timed("fwd_acceleration", engine.fwd_acceleration, m, d)
        efc = timed("make_constraint", constraints.make_constraint, m, d)
        d = timed("solver", solver.solve, m, d, efc)
        niters.append(d.solver_niter.float().cpu().numpy())
        d = timed("sensor_acc", sensors.sensor_acc, m, d)
        d = timed("euler", engine.euler, m, d.replace(qacc_warmstart=d.qacc))
    timed("observe", env._observe, state.replace(data=d))
    nit = np.stack(niters)
    return {"stage_ms_one_step": stages, "nefc": efc.nefc,
            "newton_iters_max_per_substep": nit.max(1).tolist(),
            "newton_iters_mean_per_substep": nit.mean(1).tolist()}


def kernel_vs_plain(linalg, batch):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((batch, 27, 27))
    a = torch.as_tensor(q @ q.transpose(0, 2, 1) + 27 * np.eye(27),
                        dtype=torch.float32, device="cuda")
    rhs = torch.ones(batch, 27, device="cuda")
    out = {}
    for name, fn in (("kernel", linalg.chol_solve_cuda),
                     ("plain", linalg.chol_solve_reference)):
        for _ in range(5):
            fn(a, rhs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                fn(a, rhs)
            torch.cuda.synchronize()
        kernels = _kernel_events(prof)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            fn(a, rhs)
        end.record()
        end.synchronize()
        out[name] = {
            "device_us_per_call": _device_us(kernels) / 50,
            "device_kernels_per_call": len(kernels) / 50,
            "event_us_per_call_back_to_back": start.elapsed_time(end) * 5,
        }
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--out", help="also write the JSON to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dm_control_torch import suite
    from dm_control_torch.ops import linalg

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    linalg.build()
    env = suite.load_batch("humanoid", "run", device="cuda",
                           dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    act_gen = torch.Generator(device="cuda").manual_seed(1)

    def act():
        return 2 * torch.rand(args.batch, env.model.nu, generator=act_gen,
                              device="cuda") - 1

    t0 = time.perf_counter()
    state, _ = env.reset(args.batch, gen)
    torch.cuda.synchronize()
    out = {"card": card, "batch": args.batch,
           "reset_s": time.perf_counter() - t0}
    for _ in range(2):  # warm-up
        state, _ = env.step(state, act())
    torch.cuda.synchronize()
    state, prof = profile_step(env, state, act)
    out.update(prof)
    out.update(stage_times(env, state, act))
    out["chol_solve_n27_f32"] = kernel_vs_plain(linalg, args.batch)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
