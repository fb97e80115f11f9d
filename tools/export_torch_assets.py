"""Writes the PyTorch port's model assets and its float64 golden files.

The port (``dm_control_torch``) cannot compile MJCF yet, so each of its
models is the JAX package's compiled model saved as an ``.npz``.  This
tool lives outside the port because it imports ``dm_control_tpu`` and JAX.

    JAX_PLATFORMS=cpu python tools/export_torch_assets.py [domain ...]

It writes, for every ported domain (or only the ones named),

- ``dm_control_torch/suite/assets/<asset>.npz`` for each compiled model of
  the domain (``ASSETS``: cartpole has one per pole count, reacher one per
  target size), through ``model_io.from_jax_model`` and ``model_io.save``;
- ``tests/data/torch_<domain>_golden_f64.npz``: float64 start states of
  the domain's golden task (``GOLDEN_TASKS``) for 4 environments,
  ``reset_*`` from a JAX ``BatchEnv.reset`` (key ``GOLDEN_KEY``) and
  ``contact_*`` after ``FALL_STEPS[domain]`` further control steps (for
  the domains with a floor: lying or standing on it, contacts active; for
  ball_in_cup: the string taut); for each, the per-episode model
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

#: domain -> the task its golden file steps
GOLDEN_TASKS = {
    "humanoid": "run", "pendulum": "swingup", "acrobot": "swingup",
    "cartpole": "swingup", "reacher": "easy", "walker": "run",
    "cheetah": "run", "hopper": "hop", "point_mass": "hard",
    "ball_in_cup": "catch",
}
#: domain -> control steps between the ``reset_*`` and ``contact_*`` states
FALL_STEPS = {
    "humanoid": 40, "pendulum": 10, "acrobot": 10, "cartpole": 10,
    "reacher": 10, "walker": 40, "cheetah": 10, "hopper": 40,
    "point_mass": 10, "ball_in_cup": 30,
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
}
DOMAINS = tuple(GOLDEN_TASKS)


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
            return module.get_model(*assets[asset])
    raise KeyError(asset)


def export_model(asset):
    from dm_control_torch.physics import model_io

    model_io.save(asset_path(asset), model_io.from_jax_model(
        jax_model(asset)))


def _jax_env(domain):
    from dm_control_tpu import suite

    return suite.load_batch(domain, GOLDEN_TASKS[domain], autoreset=False)


def _snapshot(state, prefix):
    out = {f"{prefix}_{f}": np.asarray(getattr(state.data, f))
           for f in STATE_FIELDS}
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
    out = _snapshot(state, "reset")
    rng = np.random.default_rng(GOLDEN_SEED + 1)
    for _ in range(FALL_STEPS[domain]):
        state, _ = env.step(state, jnp.asarray(rng.uniform(
            -1.0, 1.0, (GOLDEN_BATCH, env.model.nu))))
    out.update(_snapshot(state, "contact"))
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
    data = env._strip(make_data(m).replace(
        **{f: jnp.asarray(states[f"{prefix}_{f}"]) for f in STATE_FIELDS}))
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
                for f in STATE_FIELDS})
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
        for asset in ASSETS[domain]:
            export_model(asset)
        np.savez(golden_path(domain), **make_golden(domain))
        print("wrote", ", ".join(ASSETS[domain]), "and",
              os.path.relpath(golden_path(domain), ROOT), flush=True)


if __name__ == "__main__":
    main()
