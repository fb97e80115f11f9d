"""Writes the PyTorch port's model assets and its float64 golden files.

The port (``dm_control_torch``) cannot compile MJCF yet, so each of its
models is the JAX package's compiled model saved as an ``.npz``.  This
tool lives outside the port because it imports ``dm_control_tpu`` and JAX.

    JAX_PLATFORMS=cpu python tools/export_torch_assets.py [domain ...]

(``golden:NAME``, ``golden:quadruped_fetch`` say, writes that golden file
alone).

It writes, for every ported domain (or only the ones named),

- ``dm_control_torch/suite/assets/<asset>.npz`` for each compiled model of
  the domain (``ASSETS``: cartpole has one per pole count, reacher one per
  target size), through ``model_io.from_jax_model`` and ``model_io.save``;
- ``tests/data/torch_<golden>_golden_f64.npz`` for each golden of the
  domain (``GOLDEN_TASKS``; most domains have one, named like the domain;
  quadruped has three, ``GOLDEN_DOMAINS``): float64 start states of the
  golden's task for 4 environments,
  ``reset_*`` from a JAX ``BatchEnv.reset`` (key ``GOLDEN_KEY``) and
  ``contact_*`` after ``FALL_STEPS[golden]`` further control steps (for
  the domains with a floor: lying or standing on it, contacts active; for
  ball_in_cup: the string taut; for quadruped_fetch: the ball on the
  floor too; for finger: the spinner touching the finger; for
  manipulator: the ball in the hand; for manipulator_insert_peg: the peg
  against the slot; for stacker: a box on a box, boxes flat on the floor.
  Those four counts were picked among the states that reach the new code
  as ones where a step's result does not jump with rounding: at some
  states, manipulator's after 95 steps say, a relative change of 1e-12
  in qvel moves the next control step's qacc by 1e3); for each, the
  per-episode model
  overrides (``<prefix>_diff_<field>``), actions drawn with numpy seed
  ``GOLDEN_SEED`` and the JAX state, observation, reward, discount and
  step type after one control step (keys ``<prefix>_actions``,
  ``<prefix>_step_*``, ``<prefix>_obs_*``, ``<prefix>_reward``, ...).
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET_DIR = os.path.join(ROOT, "dm_control_torch", "suite", "assets")
GOLDEN_KEY = 7
GOLDEN_SEED = 11
GOLDEN_BATCH = 4
PREFIXES = ("reset", "contact")
STATE_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time")

#: golden -> the task its file steps
GOLDEN_TASKS = {
    "humanoid": "run", "pendulum": "swingup", "acrobot": "swingup",
    "cartpole": "swingup", "reacher": "easy", "walker": "run",
    "cheetah": "run", "hopper": "hop", "point_mass": "hard",
    "ball_in_cup": "catch", "quadruped": "walk",
    "quadruped_escape": "escape", "quadruped_fetch": "fetch",
    "fish": "swim", "swimmer": "swimmer6", "finger": "turn_hard",
    "manipulator": "bring_ball", "manipulator_insert_peg": "insert_peg",
    "stacker": "stack_4",
}
#: golden -> its domain, where the two names differ
GOLDEN_DOMAINS = {"quadruped_escape": "quadruped",
                  "quadruped_fetch": "quadruped",
                  "manipulator_insert_peg": "manipulator"}
#: golden -> control steps between the ``reset_*`` and ``contact_*`` states
FALL_STEPS = {
    "humanoid": 40, "pendulum": 10, "acrobot": 10, "cartpole": 10,
    "reacher": 10, "walker": 40, "cheetah": 10, "hopper": 40,
    "point_mass": 10, "ball_in_cup": 30, "quadruped": 50,
    "quadruped_escape": 25, "quadruped_fetch": 200, "fish": 10,
    "swimmer": 10, "finger": 95, "manipulator": 65,
    "manipulator_insert_peg": 429, "stacker": 55,
}
#: domain -> {asset name: arguments of the JAX domain's get_model}
ASSETS = {
    "humanoid": {"humanoid": ()}, "pendulum": {"pendulum": ()},
    "acrobot": {"acrobot": ()},
    "cartpole": {"cartpole": (1,), "cartpole_2": (2,), "cartpole_3": (3,)},
    "reacher": {"reacher_easy": (0.05,), "reacher_hard": (0.015,)},
    "walker": {"walker": ()}, "cheetah": {"cheetah": ()},
    "hopper": {"hopper": ()}, "point_mass": {"point_mass": ()},
    "ball_in_cup": {"ball_in_cup": ()},
    "quadruped": {
        "quadruped_walk": dict(floor_size=10.0),
        "quadruped_run": dict(floor_size=100),
        "quadruped_escape": dict(floor_size=40, terrain=True,
                                 rangefinders=True),
        "quadruped_fetch": dict(walls_and_ball=True)},
    "fish": {"fish": ()},
    "swimmer": {"swimmer6": (6,), "swimmer15": (15,)},
    "finger": {"finger": ()},
    "manipulator": {
        "manipulator_bring_ball": (False, False),
        "manipulator_bring_peg": (True, False),
        "manipulator_insert_ball": (False, True),
        "manipulator_insert_peg": (True, True)},
    "stacker": {"stacker_2": (2,), "stacker_4": (4,)},
}
DOMAINS = tuple(ASSETS)
GOLDENS = tuple(GOLDEN_TASKS)


def golden_domain(golden):
    return GOLDEN_DOMAINS.get(golden, golden)


def goldens_of(domain):
    return tuple(g for g in GOLDENS if golden_domain(g) == domain)


def asset_path(asset):
    return os.path.join(ASSET_DIR, asset + ".npz")


def golden_path(domain):
    return os.path.join(ROOT, "tests", "data",
                        f"torch_{domain}_golden_f64.npz")


def jax_model(asset):
    """The JAX package's compiled model behind an asset name."""
    import importlib

    for domain, assets in ASSETS.items():
        if asset in assets:
            module = importlib.import_module(f"dm_control_tpu.suite.{domain}")
            args = assets[asset]
            if isinstance(args, dict):
                return module.get_model(**args)
            return module.get_model(*args)
    raise KeyError(asset)


def export_model(asset):
    from dm_control_torch.physics import model_io

    model_io.save(asset_path(asset), model_io.from_jax_model(
        jax_model(asset)))


def _jax_env(golden):
    from dm_control_tpu import suite

    return suite.load_batch(golden_domain(golden), GOLDEN_TASKS[golden],
                            autoreset=False)


def _state_fields(m):
    """The recorded state fields: ``act`` only where the model has one."""
    return STATE_FIELDS + (("act",) if m.na else ())


def _snapshot(state, prefix, fields):
    out = {f"{prefix}_{f}": np.asarray(getattr(state.data, f))
           for f in fields}
    out.update({f"{prefix}_diff_{k}": np.asarray(v)
                for k, v in state.model_diff.items()})
    return out


def golden_states(domain):
    """The float64 start states: ``reset_*`` from a JAX reset, and
    ``contact_*``, the same environments ``FALL_STEPS[domain]`` control
    steps later."""
    import jax
    import jax.numpy as jnp

    env = _jax_env(domain)
    state, _ = env.reset(jax.random.split(jax.random.PRNGKey(GOLDEN_KEY),
                                          GOLDEN_BATCH))
    fields = _state_fields(env.model)
    out = _snapshot(state, "reset", fields)
    rng = np.random.default_rng(GOLDEN_SEED + 1)
    for _ in range(FALL_STEPS[domain]):
        state, _ = env.step(state, jnp.asarray(rng.uniform(
            -1.0, 1.0, (GOLDEN_BATCH, env.model.nu))))
    out.update(_snapshot(state, "contact", fields))
    return out


def golden_step(domain, states, prefix):
    """One JAX control step from the start states ``states[prefix_*]``
    with actions drawn from numpy seed ``GOLDEN_SEED``."""
    import jax.numpy as jnp

    from dm_control_torch.rl.golden import model_diff
    from dm_control_tpu.physics.model import make_data
    from dm_control_tpu.rl.control import EnvState

    env = _jax_env(domain)
    m = env.model
    B = states[f"{prefix}_qpos"].shape[0]
    actions = np.random.default_rng(GOLDEN_SEED).uniform(
        -1.0, 1.0, (B, m.nu))
    fields = _state_fields(m)
    data = env._strip(make_data(m).replace(
        **{f: jnp.asarray(states[f"{prefix}_{f}"]) for f in fields}))
    diff = {k: jnp.asarray(v)
            for k, v in model_diff(states, prefix).items()}
    state = EnvState(data=data, model_diff=diff, rng=None,
                     step_count=jnp.zeros(B, jnp.int32),
                     needs_reset=jnp.zeros(B, bool))
    state, ts = env.step(state, jnp.asarray(actions))
    out = {f"{prefix}_actions": actions,
           f"{prefix}_reward": np.asarray(ts.reward),
           f"{prefix}_discount": np.asarray(ts.discount),
           f"{prefix}_step_type": np.asarray(ts.step_type)}
    out.update({f"{prefix}_step_{f}": np.asarray(getattr(state.data, f))
                for f in fields})
    out.update({f"{prefix}_obs_{k}": np.asarray(v)
                for k, v in ts.observation.items()})
    return out


def make_golden(domain="humanoid"):
    golden = golden_states(domain)
    for prefix in PREFIXES:
        golden.update(golden_step(domain, golden, prefix))
    return golden


def main(argv=None):
    sys.path.insert(0, ROOT)
    args = list(sys.argv[1:] if argv is None else argv)
    import jax

    jax.config.update("jax_enable_x64", True)
    for domain in args or DOMAINS:
        if domain.startswith("golden:"):
            golden = domain[len("golden:"):]
            np.savez(golden_path(golden), **make_golden(golden))
            print("wrote", os.path.relpath(golden_path(golden), ROOT),
                  flush=True)
            continue
        for asset in ASSETS[domain]:
            export_model(asset)
        print("wrote", ", ".join(ASSETS[domain]), flush=True)
        for golden in goldens_of(domain):
            np.savez(golden_path(golden), **make_golden(golden))
            print("wrote", os.path.relpath(golden_path(golden), ROOT),
                  flush=True)


if __name__ == "__main__":
    main()
