"""Writes the PyTorch port's model asset and its float64 golden file.

The port (``dm_control_torch``) cannot compile MJCF yet, so its humanoid
model is the JAX package's compiled model saved as an ``.npz``.  This tool
lives outside the port because it imports ``dm_control_tpu`` and JAX.

    JAX_PLATFORMS=cpu python tools/export_torch_assets.py

writes

- ``dm_control_torch/suite/assets/humanoid.npz``: ``humanoid.get_model()``
  through ``model_io.from_jax_model`` and ``model_io.save``;
- ``tests/data/torch_humanoid_golden_f64.npz``: float64 start states of
  humanoid:run for 4 environments, ``reset_*`` from a JAX
  ``BatchEnv.reset`` (key ``GOLDEN_KEY``) and ``contact_*`` after
  ``GOLDEN_FALL_STEPS`` further control steps (on the floor, contacts
  active); for each, actions drawn with numpy seed ``GOLDEN_SEED`` and the
  JAX state, observation, reward, discount and step type after one control
  step (keys ``<prefix>_actions``, ``<prefix>_step_*``, ``<prefix>_obs_*``,
  ``<prefix>_reward``, ...).
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "dm_control_torch", "suite", "assets",
                     "humanoid.npz")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_humanoid_golden_f64.npz")
GOLDEN_KEY = 7
GOLDEN_SEED = 11
GOLDEN_BATCH = 4
GOLDEN_FALL_STEPS = 40
PREFIXES = ("reset", "contact")
STATE_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time")


def export_model(path=ASSET):
    from dm_control_tpu.suite import humanoid
    from dm_control_torch.physics import model_io

    model_io.save(path, model_io.from_jax_model(humanoid.get_model()))


def _jax_env():
    from dm_control_tpu import suite

    return suite.load_batch("humanoid", "run", autoreset=False)


def golden_states():
    """The float64 start states: ``reset_*`` from a JAX reset, and
    ``contact_*``, the same environments after ``GOLDEN_FALL_STEPS``
    control steps, lying on the floor with contacts active."""
    import jax
    import jax.numpy as jnp

    env = _jax_env()
    state, _ = env.reset(jax.random.split(jax.random.PRNGKey(GOLDEN_KEY),
                                          GOLDEN_BATCH))
    out = {f"reset_{f}": np.asarray(getattr(state.data, f))
           for f in STATE_FIELDS}
    rng = np.random.default_rng(GOLDEN_SEED + 1)
    for _ in range(GOLDEN_FALL_STEPS):
        state, _ = env.step(state, jnp.asarray(rng.uniform(
            -1.0, 1.0, (GOLDEN_BATCH, env.model.nu))))
    out.update({f"contact_{f}": np.asarray(getattr(state.data, f))
                for f in STATE_FIELDS})
    return out


def golden_step(states, prefix):
    """One JAX control step from the start states ``states[prefix_*]``
    with actions drawn from numpy seed ``GOLDEN_SEED``."""
    import jax.numpy as jnp

    from dm_control_tpu.physics.model import make_data
    from dm_control_tpu.rl.control import EnvState

    env = _jax_env()
    m = env.model
    B = states[f"{prefix}_qpos"].shape[0]
    actions = np.random.default_rng(GOLDEN_SEED).uniform(
        -1.0, 1.0, (B, m.nu))
    data = env._strip(make_data(m).replace(
        **{f: jnp.asarray(states[f"{prefix}_{f}"]) for f in STATE_FIELDS}))
    state = EnvState(data=data, model_diff={}, rng=None,
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


def make_golden():
    golden = golden_states()
    for prefix in PREFIXES:
        golden.update(golden_step(golden, prefix))
    return golden


def main():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)
    export_model()
    np.savez(GOLDEN, **make_golden())
    print("wrote", ASSET, "and", GOLDEN)


if __name__ == "__main__":
    main()
