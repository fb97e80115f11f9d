"""Writes ``tests/data/torch_bc_cartpole_f64.npz``: the JAX package's
behaviour-cloning pipeline (``dm_control_tpu/scripts``) on small inputs in
float64, the figures ``tests/test_torch_bc.py`` holds the port's scripts
to without compiling JAX.

    JAX_PLATFORMS=cpu python tools/export_bc_golden.py

It records, on cartpole:swingup (``task_kwargs={"random": 0}``, a fresh
environment for each item):

- ``cem_returns``: ``CEMSolver._batch_returns`` of ``candidates()`` from
  the reset state; ``cem_segment_<field>``: ``_apply_segment``'s state
  after the first candidate;
- ``cem_solve_actions`` and ``cem_solve_returns``: ``solve`` of
  ``SOLVE_STEPS`` actions (two segments) with ``jax.random.normal``
  replaced by ``solve_draws()`` in order, and each segment's return;
- for ``gpt`` and ``ffnet`` (``model_configs``): the JAX ``Trainer``'s
  parameters after ``init`` cast to float64 (``<name>_init/<path>``), the
  loss of each step of one epoch over ``synthetic()``
  (``<name>_losses``), the parameters after it (``<name>_final/<path>``),
  and ``evaluate.run_episode`` of those parameters with
  ``reference_actions()`` and ``CONTEXT_STEPS`` (``<name>_eval_return``,
  ``_preds``, ``_mse``);
- ``replay_return`` and ``replay_obs``:
  ``evaluate.run_episode_with_reference_actions``;
- ``dataset_<key>``: the rows ``create_dataset`` writes for two action
  files, ``reference_actions()`` and ``reference_actions(4)``.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "tests", "data", "torch_bc_cartpole_f64.npz")
POPULATION, SEGMENT, ITERATIONS = 8, 4, 2
SOLVE_STEPS = 2 * SEGMENT
CONTEXT_STEPS = 4
EPISODE_STEPS = 12
#: the trainer's settings: the learning rate and every warm-up scale of
#: the epoch are exact in float32 (the JAX step takes its scale as one)
TRAINER = dict(max_epochs=1, batch_size=8, learning_rate=2.0 ** -10,
               lr_decay=True, warmup_tokens=1024, final_tokens=4096,
               grad_norm_clip=0.5, weight_decay=0.1)
STATE = ("qpos", "qvel", "time", "qacc_warmstart")


def candidates():
    return np.random.RandomState(1).uniform(-1, 1, (POPULATION, SEGMENT, 1))


def solve_draws():
    """The normal draws of ``solve``: 2 segments x ``ITERATIONS``."""
    return np.random.RandomState(2).standard_normal(
        (2 * ITERATIONS, POPULATION, SEGMENT, 1))


def reference_actions(seed=3):
    return np.random.RandomState(seed).uniform(-1, 1, (EPISODE_STEPS, 1))


def synthetic(seed=0, n_eps=6, obs_dim=5, act_dim=1):
    """Episodes of 8-29 steps of float64 observations and tanh actions."""
    rng = np.random.RandomState(seed)
    w = rng.randn(obs_dim, act_dim) * 0.3
    obs, act, done = [], [], []
    for _ in range(n_eps):
        n = rng.randint(8, 30)
        o = rng.randn(n, obs_dim)
        d = np.zeros(n, bool)
        d[-1] = True
        obs.append(o)
        act.append(np.tanh(o @ w))
        done.append(d)
    return np.concatenate(obs), np.concatenate(act), np.concatenate(done)


def model_configs():
    """name -> (the JAX config's keyword arguments, block size)."""
    return {
        "gpt": (dict(obs_size=5, action_size=1, block_size=4, n_layer=2,
                     n_head=2, n_embd=32, embd_pdrop=0.0, resid_pdrop=0.0,
                     attn_pdrop=0.0), 4),
        "ffnet": (dict(obs_size=5, action_size=1, hidden_size=32), 1),
    }


def flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflatten(golden, prefix):
    """The nested parameter tree stored under ``prefix/``."""
    tree = {}
    for key, v in golden.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(v)
    return tree


def _env():
    from dm_control_tpu import suite

    return suite.load("cartpole", "swingup", task_kwargs={"random": 0})


def _cem(out):
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.scripts.solver import CEMSolver

    env = _env()
    env.reset()
    solver = CEMSolver(env.physics.model, env.task,
                       n_sub_steps=env._n_sub_steps, segment_length=SEGMENT,
                       n_iterations=ITERATIONS, population=POPULATION)
    data = env.physics.data
    out["cem_returns"] = np.asarray(solver._batch_returns(data, candidates()))
    d = solver._apply_segment(data, candidates()[0])
    for f in STATE:
        out[f"cem_segment_{f}"] = np.asarray(getattr(d, f))
    draws = iter(solve_draws())
    returns = []
    segment = solver.solve_segment

    def recorded(*args, **kwargs):
        acts, ret = segment(*args, **kwargs)
        returns.append(ret)
        return acts, ret

    solver.solve_segment = recorded
    normal = jax.random.normal
    jax.random.normal = lambda key, shape, *a, **k: jnp.asarray(next(draws))
    try:
        out["cem_solve_actions"] = solver.solve(data, SOLVE_STEPS, seed=0)
    finally:
        jax.random.normal = normal
    out["cem_solve_returns"] = np.asarray(returns)


def _trainer(out, name):
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.scripts import evaluate, model
    from dm_control_tpu.scripts.dataset import TrajectoryDataset
    from dm_control_tpu.scripts.trainer import Trainer, TrainerConfig

    kwargs, block = model_configs()[name]
    if name == "gpt":
        config = model.GPTConfig(**kwargs)
        module = model.GPT(config)
    else:
        config = model.FFConfig(**kwargs)
        module = model.FFNet(config)
    ds = TrajectoryDataset.from_arrays(*synthetic(), block_size=block)
    tr = Trainer(module, ds, None, TrainerConfig(**TRAINER))
    tr.init()
    tr.params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                       tr.params)
    tr.opt_state = tr._optimizer.init(tr.params)
    out.update(flatten(tr.params, f"{name}_init"))
    losses = []
    step = tr._train_step

    def recorded(*args):
        params, opt_state, loss = step(*args)
        losses.append(float(loss))
        return params, opt_state, loss

    tr._train_step = recorded
    tr.train()
    out[f"{name}_losses"] = np.asarray(losses)
    out.update(flatten(tr.params, f"{name}_final"))
    ret, preds, mse = evaluate.run_episode(
        _env(), module, tr.params, config,
        reference_actions=reference_actions(),
        context_steps=CONTEXT_STEPS)
    out[f"{name}_eval_return"] = np.asarray(ret)
    out[f"{name}_eval_preds"] = np.asarray(preds)
    out[f"{name}_eval_mse"] = np.asarray(mse)


def _replay(out):
    import h5py

    from dm_control_tpu.scripts import create_dataset, evaluate

    ret, obs = evaluate.run_episode_with_reference_actions(
        _env(), reference_actions())
    out["replay_return"] = np.asarray(ret)
    out["replay_obs"] = obs
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for k, seed in enumerate((3, 4)):
            files.append(os.path.join(tmp, f"opt_acts_{k}.npy"))
            np.save(files[-1], reference_actions(seed))
        path = os.path.join(tmp, "dataset.hdf5")
        create_dataset.create_dataset(lambda p: _env(), files, path)
        with h5py.File(path, "r") as f:
            for k in f["observables"]:
                out[f"dataset_obs_{k}"] = np.asarray(f["observables"][k])
            for k in ("actions", "dones", "rewards"):
                out[f"dataset_{k}"] = np.asarray(f[k])


def make_golden():
    """The golden's arrays from a fresh run of the JAX package."""
    import jax

    jax.config.update("jax_enable_x64", True)
    out = {}
    _cem(out)
    for name in model_configs():
        _trainer(out, name)
    _replay(out)
    return out


def main():
    sys.path.insert(0, ROOT)
    np.savez(PATH, **make_golden())
    print("wrote", os.path.relpath(PATH, ROOT))


if __name__ == "__main__":
    main()
