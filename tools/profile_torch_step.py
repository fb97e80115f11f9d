"""Where the time of one control step of a suite task goes on the GPU.

    python3 tools/profile_torch_step.py [--domain humanoid] [--task run]
        [--batch 1024] [--out FILE.json]

Runs the port (``dm_control_torch``) at float32 on one CUDA device and
prints (and with ``--out`` also writes) one JSON object:

- one profiled ``BatchEnv.step``: device kernels per step, device busy
  time and idle share (``torch.profiler``), the top operators by device
  and by host time, and the chol_solve launches of that step;
- host milliseconds per pipeline stage over one control step (all its
  substeps and, under RK4, all four ``forward``s of each), with a
  ``torch.cuda.synchronize()`` around each stage, and the Newton
  iterations per solve (max and mean over the batch);
- the chol_solve kernel against its plain version at (B, nv) float32:
  device time per call from the profiler, and CUDA-event time per call
  over 200 back-to-back calls;
- the reset by stage: seconds in the task's ``init`` and, for quadruped, in
  ``_drop_to_ground`` (with its rounds) and in what ``init`` does besides
  (escape's terrain draw); the rounds of the reset's rejection loop;
- one ``collision.collision`` of the model: its device kernels, and how
  many of them the ellipsoid's closest-point iteration launches;
- the peak device memory of the reset and the steps
  (``torch.cuda.max_memory_allocated``), and for a model with noslip the
  contacts its sweep visited a substep.

Needs a CUDA device and no JAX.
"""

from __future__ import annotations

import argparse
import functools
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


def profile_step(env, state, act, linalg):
    linalg.chol_solve.launches = 0
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
        "chol_solve_launches_per_step": linalg.chol_solve.launches,
        "device_kernels_per_step": len(kernels),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "top_device_ms": [(e.key, _self_device_us(e) / 1e3, e.count)
                          for e in by_dev],
        "top_cpu_ms": [(e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in by_cpu],
    }


#: the pipeline stages timed by ``stage_times``: (module, function)
STAGES = (
    ("kinematics", "kinematics"), ("kinematics", "com_pos"),
    ("kinematics", "tendon"), ("inertia", "crb"),
    ("collision", "collision"), ("actuation", "transmission"),
    ("sensors", "sensor_pos"), ("engine", "fwd_velocity"),
    ("sensors", "sensor_vel"), ("engine", "fwd_actuation"),
    ("engine", "fwd_acceleration"), ("constraints", "make_constraint"),
    ("solver", "solve"), ("solver", "noslip"), ("sensors", "sensor_acc"),
    ("engine", "euler"),
)
#: stages timed inside another one (noslip inside solve)
NESTED = ("noslip",)


def stage_times(env, state, act):
    """Host ms per stage over one ``BatchEnv.step``: each stage function
    is wrapped, for this one step, by a timer with a synchronize on both
    sides.  ``observe`` is the step's closing recompute as a whole, and
    ``other`` what no stage accounts for (integration, reward, RK4's
    stage arithmetic)."""
    import importlib

    physics = {name: importlib.import_module(
        f"dm_control_torch.physics.{name}") for name, _ in STAGES}
    stages, niters, nefc = {}, [], [0]
    in_observe = [False]

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if in_observe[0]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) \
                + (time.perf_counter() - t) * 1e3
            if name == "solve":
                niters.append(out.solver_niter.float().cpu().numpy())
            if name == "make_constraint":
                nefc[0] = out.nefc
            return out
        return wrapper

    def observe(st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        in_observe[0] = True
        try:
            out = real_observe(st)
        finally:
            in_observe[0] = False
        torch.cuda.synchronize()
        stages["observe"] = (time.perf_counter() - t) * 1e3
        return out

    real = {(mod, fn): getattr(physics[mod], fn) for mod, fn in STAGES}
    real_observe = env._observe
    try:
        for (mod, fn), f in real.items():
            setattr(physics[mod], fn, timed(fn, f))
        env._observe = observe
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env.step(state, act())
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, fn), f in real.items():
            setattr(physics[mod], fn, f)
        del env._observe
    stages["other"] = total - sum(v for k, v in stages.items()
                                  if k not in NESTED)
    out = {"stage_ms_one_step": stages, "stage_ms_sum": total,
           "nefc": nefc[0], "solves_per_step": len(niters)}
    if niters:
        nit = np.stack(niters)
        out["newton_iters_max_per_solve"] = nit.max(1).tolist()
        out["newton_iters_mean_per_solve"] = nit.mean(1).tolist()
    return out


def reset_times(env, batch, gen):
    """A reset with a synchronize around the task's ``init`` and around
    quadruped's ``_drop_to_ground``: seconds of each, the rounds the drop
    took, and ``init_other_s``, what ``init`` did besides the drop (for
    escape the terrain draw and its resize)."""
    task = env.task
    spent = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrapper

    task.init = timed("init_s", task.init)
    if hasattr(task, "_drop_to_ground"):
        task._drop_to_ground = timed("drop_to_ground_s",
                                     task._drop_to_ground)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = env.reset(batch, gen)
        torch.cuda.synchronize()
        spent["reset_s"] = time.perf_counter() - t0
    finally:
        del task.init
        if "_drop_to_ground" in vars(task):
            del task._drop_to_ground
    spent["rejection_rounds"] = env.last_rejection_rounds
    if "drop_to_ground_s" in spent:
        spent["drop_rounds"] = task.last_drop_rounds
        spent["init_other_s"] = spent["init_s"] - spent["drop_to_ground_s"]
    return state, spent


def collision_kernels(env, state):
    """Device kernels of one ``collision.collision`` at the state, and the
    share of the ellipsoid's closest-point iteration: its calls and the
    kernels they launch."""
    from dm_control_torch.physics import collision, kinematics
    from dm_control_torch.rl.control import apply_model_diff

    m = apply_model_diff(env.model, state.model_diff)
    d = kinematics.kinematics(m, env._unstrip(state.data))
    collision.collision(m, d)  # warm the model's caches
    real = collision._ellipsoid_closest
    inside = []

    def counted(c, size):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = real(c, size)
            torch.cuda.synchronize()
        inside.append(len(_kernel_events(prof)))
        return out

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        collision.collision(m, d)
        torch.cuda.synchronize()
    total = len(_kernel_events(prof))
    collision._ellipsoid_closest = counted
    try:
        collision.collision(m, d)
    finally:
        collision._ellipsoid_closest = real
    return {"collision_device_kernels": total,
            "contact_rows": len(d.contact.dim),
            "ellipsoid_closest_calls": len(inside),
            "ellipsoid_closest_device_kernels": sum(inside)}


def kernel_vs_plain(linalg, batch, n):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((batch, n, n))
    a = torch.as_tensor(q @ q.transpose(0, 2, 1) + n * np.eye(n),
                        dtype=torch.float32, device="cuda")
    rhs = torch.ones(batch, n, device="cuda")
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
    parser.add_argument("--domain", default="humanoid")
    parser.add_argument("--task", default="run")
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--out", help="also write the JSON to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dm_control_torch import suite
    from dm_control_torch.ops import linalg
    from dm_control_torch.physics import solver

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    linalg.build()
    env = suite.load_batch(args.domain, args.task, device="cuda",
                           dtype=torch.float32,
                           task_kwargs={"random": 0}
                           if args.domain == "lqr" else None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    act_gen = torch.Generator(device="cuda").manual_seed(1)

    def act():
        return 2 * torch.rand(args.batch, env.model.nu, generator=act_gen,
                              device="cuda") - 1

    torch.cuda.reset_peak_memory_stats()
    state, reset = reset_times(env, args.batch, gen)
    out = {"card": card, "domain": args.domain, "task": args.task,
           "batch": args.batch, "nv": env.model.nv,
           "substeps_per_step": env.n_sub_steps, **reset}
    out.update(collision_kernels(env, state))
    solver.noslip.slots = 0
    for _ in range(2):  # warm-up
        state, _ = env.step(state, act())
    torch.cuda.synchronize()
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["contact_cap"] = env.model.opt.contact_cap
    if env.model.opt.noslip_iterations:
        out["noslip_contacts_per_substep"] = (
            solver.noslip.slots / (2 * env.n_sub_steps))
    # an environment that just diverged must not pull a whole reset (for
    # cheetah, 200 settle steps) into the one step that is measured
    state = state.replace(needs_reset=torch.zeros_like(state.needs_reset))
    state, prof = profile_step(env, state, act, linalg)
    state = state.replace(needs_reset=torch.zeros_like(state.needs_reset))
    out.update(prof)
    out.update(stage_times(env, state, act))
    out[f"chol_solve_n{env.model.nv}_f32"] = kernel_vs_plain(
        linalg, args.batch, env.model.nv)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
