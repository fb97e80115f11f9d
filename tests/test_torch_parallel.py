"""``dm_control_torch.parallel`` and the two learners that take a mesh.

Two processes (``tests/torch_parallel_worker.py``) join a gloo group on
localhost, each with its own time limit, so that a hang fails the test
instead of eating the suite's clock; each runs one PPO train step on
pendulum:swingup with half of a global batch of 8 and two ``Trainer``
steps with half of each batch, in float64.  The same run in one process
without a mesh gives the same parameters and env rows within 1e-10 (of
max(1, scale) for the trainer).  The mesh helpers are checked at world
size 1 in this process."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_helpers import ROOT
from torch_parallel_worker import PPO_BATCH, ppo_step, trainer_steps

from dm_control_torch import parallel

WORLD = 2
#: seconds each worker may take (its start, the env's compile, the steps)
WORKER_TIMEOUT = 120
TOL = 1e-10


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks wrote."""
    tmp = tmp_path_factory.mktemp("parallel")
    port = str(_free_port())
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(WORLD), port,
         str(tmp / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            logs.append(out.decode(errors="replace")[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    out = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def single_ppo():
    return ppo_step()


@pytest.fixture(scope="module")
def single_bc():
    return trainer_steps()


def test_ppo_step_two_ranks_equal_one_process(ranks, single_ppo):
    rows = PPO_BATCH // WORLD
    for r, got in enumerate(ranks):
        for k, want in single_ppo.items():
            if k.startswith("param_"):
                np.testing.assert_allclose(got[f"ppo_{k}"], want, rtol=0,
                                           atol=TOL, err_msg=k)
        for k in ("env_qpos", "env_qvel", "last_obs"):
            np.testing.assert_allclose(
                got[f"ppo_{k}"], single_ppo[k][r * rows:(r + 1) * rows],
                rtol=0, atol=TOL, err_msg=k)
        for k in ("mean_reward", "env_steps", "pi_loss", "v_loss"):
            np.testing.assert_allclose(got[f"ppo_metric_{k}"],
                                       single_ppo[f"metric_{k}"], rtol=0,
                                       atol=TOL, err_msg=k)


def test_trainer_steps_two_ranks_equal_one_process(ranks, single_bc):
    for got in ranks:
        for k, want in single_bc.items():
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got[f"bc_{k}"], want, rtol=0,
                                       atol=TOL * scale, err_msg=k)


def test_assert_partitioned_two_ranks_refuses_whole_or_uneven_rows(ranks):
    """Each rank's PPO env state passed the check (the worker calls it);
    a tensor held whole on every rank, or split unevenly, raises on both
    ranks."""
    for got in ranks:
        assert bool(got["raised_whole"]) and bool(got["raised_uneven"])


def test_mesh_helpers_at_world_size_one():
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.size) == (0, 1, 1)
    assert mesh.axis_names == ("env",) and mesh.rows(6) == slice(0, 6)
    assert parallel.env_sharding(mesh).axis_names == ("env",)
    assert parallel.replicated(mesh).is_fully_replicated
    tree = {"x": torch.arange(6.0).reshape(3, 2), "k": torch.tensor(2.0),
            "g": torch.Generator()}
    placed = parallel.shard_batch(mesh, tree)
    assert torch.equal(placed["x"], tree["x"]) and placed["g"] is tree["g"]
    fn = parallel.shard_env_map(mesh, lambda s: s + 1)
    assert torch.equal(fn(tree["x"]), tree["x"] + 1)
    assert torch.equal(parallel.all_gather_rows(mesh, tree["x"]), tree["x"])
    grads = [torch.ones(2)]
    assert torch.equal(parallel.all_reduce_mean(mesh, grads)[0],
                       torch.ones(2))
    # one process and no coordinator: nothing to join
    parallel.initialize()
    assert not torch.distributed.is_initialized()
    pod = parallel.pod_mesh(device="cpu")
    assert pod.axis_names == ("host", "env")
    assert parallel.env_batch_sharding(pod).axis_names == ("host", "env")
    glob = parallel.make_global_env_batch(mesh, tree)
    parallel.assert_partitioned(glob, mesh, 3)
    with pytest.raises(ValueError, match="does not split"):
        parallel.Mesh(0, 4, torch.device("cpu")).rows(6)
    with pytest.raises(ValueError, match="coordinator"):
        parallel.initialize(num_processes=2)


def test_mesh_of_world_one_equals_no_mesh(single_ppo, single_bc):
    """``mesh=`` at world size 1, without a process group, changes
    nothing."""
    mesh = parallel.make_mesh(device="cpu")
    for got, want in ((ppo_step(mesh), single_ppo),
                      (trainer_steps(mesh), single_bc)):
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_trainer_refuses_a_mesh_on_another_device():
    from dm_control_torch.scripts import model, trainer

    mesh = parallel.Mesh(0, 1, torch.device("cuda"))
    with pytest.raises(ValueError, match="not the mesh's"):
        trainer.Trainer(model.FFNet(model.FFConfig(4, 2, hidden_size=8)),
                        None, None, trainer.TrainerConfig(), mesh=mesh,
                        device="cpu")
