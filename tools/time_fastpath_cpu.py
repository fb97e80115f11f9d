"""Times the fused fast path's plain version against the general engine on
the CPU, single-threaded, in float64 at B = 4: a cheetah:run
``BatchEnv.reset`` (its 200 settle steps) and one walker:run control step
(10 substeps), each through the fast path and with it removed
(``BatchEnv._fast = None``: ``engine.step``).  These are the paths the
CPU tests reset and step many times.

    python tools/time_fastpath_cpu.py [--repeats 3]

Prints one line a case with the best of ``--repeats`` wall times.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dm_control_torch import suite  # noqa: E402

BATCH = 4


def _best(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    for fast in (True, False):
        way = "fast path (plain version)" if fast else "engine.step"
        env = suite.load_batch("cheetah", "run", device="cpu",
                               dtype=torch.float64)
        if not fast:
            env._fast = None
        reset_s = _best(lambda: env.reset(
            BATCH, torch.Generator().manual_seed(0)), args.repeats)
        print(f"cheetah:run BatchEnv.reset B={BATCH} float64 "
              f"({env.task.settle_steps} settle steps), {way}: "
              f"{reset_s:.3f} s", flush=True)
        env = suite.load_batch("walker", "run", device="cpu",
                               dtype=torch.float64)
        if not fast:
            env._fast = None
        state, _ = env.reset(BATCH, torch.Generator().manual_seed(0))
        action = torch.zeros(BATCH, env.model.nu, dtype=torch.float64)
        state, _ = env.step(state, action)  # from a state past the reset
        step_s = _best(lambda: env.step(state, action), args.repeats)
        print(f"walker:run control step B={BATCH} float64 "
              f"({env.n_sub_steps} substeps), {way}: {1e3 * step_s:.1f} ms",
              flush=True)


if __name__ == "__main__":
    main()
