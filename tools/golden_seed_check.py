"""The golden gate's figures of a soccer host episode recording at a seed
of one's choice, beside what one rounding of its start states does.

A recording (``tests/data/torch_locomotion_env_<name>_f64.npz``, here
recorded again with another seed) is replayed one control step at a time
from its recorded states, as ``rl.golden.host_episode_errors`` replays it,
in up to four ways:

- ``port``: the port's environment, as the tests and ``chip_smoke.py``
  replay the committed recordings;
- ``port-nudged``: the same, each start state's qpos and qvel multiplied
  by 1 + 2**-52;
- ``jax``: the JAX package's environment from the recorded states (the
  replay itself, which should give the recording back);
- ``jax-nudged``: the JAX package's environment from the nudged states,
  held to its own recording: how far one rounding moves the JAX
  package's own step there.

For each way and timestep it prints the gate's two figures (every key but
qacc_warmstart, absolute; qacc_warmstart over its largest recorded entry)
beside ``ABS_GATE`` and ``REL_GATE``.  Where ``jax-nudged`` reads about
what ``port`` reads, the state's conditioning, not the port, sets the
port's distance from the recording.  On the CPU the port runs on
``--threads`` threads (1, as the tests run it): another count sums in
another order, which is a rounding of its own.

Usage, from the repository's root (the JAX ways on the CPU)::

    JAX_PLATFORMS=cpu python tools/golden_seed_check.py record \\
        soccer_humanoid_1v1 11 OUT.npz
    JAX_PLATFORMS=cpu python tools/golden_seed_check.py replay \\
        soccer_humanoid_1v1 11 OUT.npz --device cpu \\
        --ways port,port-nudged,jax,jax-nudged
    python tools/golden_seed_check.py replay soccer_humanoid_1v1 11 \\
        OUT.npz --device cuda --ways port,port-nudged
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from dm_control_torch.rl import golden  # noqa: E402

NUDGE = 2.0 ** -52
WAYS = ("port", "port-nudged", "jax", "jax-nudged")


class _HostFields:
    """A JAX ``Data``'s fields as host tensors, as the port's read."""

    def __init__(self, data):
        self._data = data

    def __getattr__(self, field):
        return torch.as_tensor(np.array(getattr(self._data, field)))


def _set_port(env, state):
    env.physics.set_data(**state)


def _set_jax(env, state):
    import jax.numpy as jnp

    physics = env.physics
    d = physics.data
    physics._data = d.replace(**{
        k: jnp.asarray(v, getattr(d, k).dtype).reshape(getattr(d, k).shape)
        for k, v in state.items()})


def replay(env, gold, set_state, nudge):
    """Per timestep, max |env - recording| by key (``episode_errors``'
    keys): ``reset``, then each recorded action from the recorded state
    before it, its qpos and qvel multiplied by ``1 + nudge``."""
    out = []
    for t in range(gold["actions"].shape[0] + 1):
        if t:
            state = {f: np.array(gold[f"t{t - 1}_step_{f}"])
                     for f in golden.EPISODE_STATE_FIELDS}
            for f in ("qpos", "qvel"):
                state[f] = state[f] * (1.0 + nudge)
            set_state(env, state)
            ts = env.step(gold["actions"][t - 1])
        else:
            ts = env.reset()
        data = env.physics.data
        if not isinstance(data.qpos, torch.Tensor):
            data = _HostFields(data)
        out.append(golden._timestep_errors(ts, data, gold, t))
    return out


def record(name, seed, path):
    import jax

    jax.config.update("jax_enable_x64", True)
    import export_torch_assets as tool

    np.savez(path, **tool.make_loco_env_golden(name, seed))
    print(f"wrote {path}: {name}, seed {seed}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("command", choices=("record", "replay"))
    parser.add_argument("name", choices=sorted(golden.SOCCER_EPISODES))
    parser.add_argument("seed", type=int)
    parser.add_argument("path")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ways", default="port,port-nudged")
    parser.add_argument("--threads", type=int, default=1)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.command == "record":
        record(args.name, args.seed, args.path)
        return 0
    with np.load(args.path, allow_pickle=False) as z:
        gold = {k: z[k] for k in z.files}
    kwargs = dict(golden.SOCCER_EPISODES[args.name], random_state=args.seed)
    for way in args.ways.split(","):
        if way not in WAYS:
            raise SystemExit(f"unknown way {way!r}: one of {WAYS}")
        if way.startswith("jax"):
            import jax

            jax.config.update("jax_enable_x64", True)
            from dm_control_tpu.locomotion import soccer

            env, set_state = soccer.load(**kwargs), _set_jax
        else:
            from dm_control_torch.locomotion import soccer

            env = soccer.load(**kwargs, device=args.device,
                              dtype=torch.float64)
            set_state = _set_port
        nudge = NUDGE if way.endswith("nudged") else 0.0
        errs = replay(env, gold, set_state, nudge)
        figures, ok = golden.episode_gate(errs, gold, args.name)
        where = "cpu" if way.startswith("jax") else args.device
        if where == "cpu" and not way.startswith("jax"):
            where += f", {args.threads} threads"
        print(f"{args.name} seed {args.seed} {way} ({where}): "
              + ", ".join(f"t{t} rest {a:.3e} qacc_warmstart {b:.3e}"
                          for t, (a, b) in enumerate(figures))
              + f"; gate {golden.ABS_GATE:g} and {golden.REL_GATE:g}: "
              + ("within" if ok else "missed"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
