"""One rank of the two-process test of ``dm_control_torch.parallel``
(``tests/test_torch_parallel.py``): joins a gloo group on localhost, runs
one PPO train step on pendulum:swingup with its half of the env batch and
two behaviour-cloning ``Trainer`` steps with its half of each batch, and
writes what it got to an ``.npz`` file.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT.npz

The test runs the same scenarios (``ppo_step``, ``trainer_steps``) in one
process without a mesh and compares.
"""

import os
import sys

import numpy as np
import torch

#: the global batch of the PPO step
PPO_BATCH = 8


def ppo_step(mesh=None):
    """One float64 PPO train step of pendulum:swingup at a global batch of
    ``PPO_BATCH``: the parameters after it, this rank's env rows and the
    metrics."""
    from dm_control_torch import suite
    from dm_control_torch.rl import ppo

    env = suite.load_batch("pendulum", "swingup", device="cpu",
                           dtype=torch.float64)
    config = ppo.PPOConfig(steps_per_batch=4, num_minibatches=2,
                           update_epochs=2)
    train_step, optimizer = ppo.make_train_step(
        env, config, obs_dtype=torch.float64, mesh=mesh)
    state = ppo.init_train_state(
        env, torch.Generator().manual_seed(3), PPO_BATCH, optimizer,
        torch.float64, mesh=mesh)
    state, metrics = train_step(state)
    if mesh is not None:
        from dm_control_torch import parallel

        parallel.assert_partitioned(state.env_state, mesh, PPO_BATCH)
    out = {f"param_{k}": v.detach().numpy()
           for k, v in state.module.state_dict().items()}
    out.update(env_qpos=state.env_state.data.qpos.numpy(),
               env_qvel=state.env_state.data.qvel.numpy(),
               last_obs=state.last_obs.numpy())
    out.update({f"metric_{k}": float(v) for k, v in metrics.items()})
    return out


def synthetic(seed=0, n_eps=6, obs_dim=4, act_dim=2):
    rng = np.random.RandomState(seed)
    w = rng.randn(obs_dim, act_dim) * 0.3
    obs = rng.randn(n_eps * 8, obs_dim)
    done = np.zeros(len(obs), bool)
    done[7::8] = True
    return obs, np.tanh(obs @ w), done


def trainer_steps(mesh=None, steps=2):
    """Two float64 ``Trainer`` steps of an FFNet (no dropout) on batches of
    8: the parameters after them and the losses."""
    from dm_control_torch.scripts import dataset, model, trainer

    ds = dataset.TrajectoryDataset.from_arrays(*synthetic(), 1)
    net = model.FFNet(model.FFConfig(4, 2, hidden_size=8)).to(torch.float64)
    tr = trainer.Trainer(net, ds, None, trainer.TrainerConfig(
        batch_size=8, learning_rate=1e-2), mesh=mesh, device="cpu")
    tr.init()
    losses = []
    batches = ds.batches(np.random.RandomState(0), 8)
    for _ in range(steps):
        obs, act = tr._prep(*next(batches))
        losses.append(float(tr._train_step(obs, act, 1.0)))
    out = {f"param_{k}": v.detach().numpy()
           for k, v in net.state_dict().items()}
    out["losses"] = np.array(losses)
    return out


def partition_checks(mesh):
    """Whether ``assert_partitioned`` passes a tree split over the ranks
    and ``make_global_env_batch`` takes each rank's rows, and whether it
    raises on a tree held whole on every rank and on uneven rows."""
    from dm_control_torch import parallel

    rows = PPO_BATCH // mesh.world_size
    split = {"x": torch.zeros(rows, 3), "k": torch.zeros(2), "t": 1.0}
    parallel.assert_partitioned(split, mesh, PPO_BATCH)
    parallel.make_global_env_batch(mesh, split)
    out = {}
    for name, tree in (
            ("whole", {"x": torch.zeros(PPO_BATCH, 3), "y": split["x"]}),
            ("uneven", {"x": torch.zeros(rows + mesh.rank, 3)})):
        try:
            parallel.assert_partitioned(tree, mesh, PPO_BATCH)
            out[f"raised_{name}"] = False
        except AssertionError:
            out[f"raised_{name}"] = True
    return out


def main():
    rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    torch.set_num_threads(1)
    from dm_control_torch import parallel

    parallel.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                        timeout=100)
    try:
        mesh = parallel.make_mesh(device="cpu")
        out = {f"ppo_{k}": v for k, v in ppo_step(mesh).items()}
        out.update({f"bc_{k}": v for k, v in trainer_steps(mesh).items()})
        out.update(partition_checks(mesh))
        np.savez(path, **out)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
