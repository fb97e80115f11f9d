"""The port's lqr path against the JAX package, in float64 on the CPU.

The model depends on the seed: the port's model of two seeds equals the
JAX package's ``get_model`` of the same seeds field by field (the asset of
each size with the seeded stiffness and damping edited in).
``lqr_solver.solve`` within 1e-10 of the JAX package's on the same mass
matrix and actuator moments.  The two tasks'
observation, reward and termination within 1e-10 on the same states
(tests/test_torch_tasks.py's comparison), one ``BatchEnv.step`` against
the golden (lqr_6_2, seed 0; ``dm_control_torch/rl/golden.py``'s gate),
and both assets equal to a fresh export.  Marked ``slow``: the golden
equals a fresh JAX run.
"""

import types

import numpy as np
import pytest
import torch

import test_torch_model_io as model_io_tests
import test_torch_tasks as tasks
from _torch_helpers import PREFIXES, assert_step_matches_golden, \
    export_tool, golden
from dm_control_torch import suite as tsuite
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import model_io
from dm_control_torch.physics.model import make_data
from dm_control_torch.suite import lqr_solver

SIZES = {"lqr_2_1": (2, 1), "lqr_6_2": (6, 2)}


def _env(task, seed):
    return tsuite.load_batch("lqr", task, device="cpu", dtype=torch.float64,
                             autoreset=False, task_kwargs={"random": seed})


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("task", SIZES)
def test_seeded_model_equals_jax(task, seed):
    from dm_control_tpu.suite import lqr as jlqr

    jm = jlqr.get_model(*SIZES[task], np.random.RandomState(seed))
    model_io_tests._assert_same(_env(task, seed).model,
                                model_io.from_jax_model(jm))


@pytest.mark.parametrize("task", SIZES)
def test_lqr_solver_matches_jax(task):
    """Both solvers on the same model (seed 5) and the same mass matrix
    and actuator moments (the port's, of environment 1)."""
    from dm_control_tpu.suite import lqr as jlqr
    from dm_control_tpu.suite import lqr_solver as jlqr_solver

    seed = 5
    env = _env(task, seed)
    m = env.model
    d = tengine.forward(m, make_data(m, 2))
    jenv = types.SimpleNamespace(
        physics=types.SimpleNamespace(
            model=jlqr.get_model(*SIZES[task], np.random.RandomState(seed)),
            data=types.SimpleNamespace(
                qM=d.qM[1].numpy(), actuator_moment=d.actuator_moment[1]
                .numpy())),
        task=types.SimpleNamespace(control_cost_coef=0.1))
    got = lqr_solver.solve(m, d, env.task.control_cost_coef, env=1)
    for g, w in zip(got, jlqr_solver.solve(jenv)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    assert 0 < got[2] < 1


@pytest.mark.parametrize("task", SIZES)
def test_task_functions_match_jax(task):
    tasks.test_task_functions_match_jax("lqr", task,
                                        task_kwargs={"random": 3})


def test_reset_draws_a_position_of_norm_sqrt2():
    state, _ = _env("lqr_6_2", 0).reset(4, torch.Generator().manual_seed(2))
    np.testing.assert_allclose(
        torch.linalg.vector_norm(state.data.qpos, dim=-1).numpy(),
        np.sqrt(2), rtol=1e-15)
    assert float(state.data.qvel.abs().max()) == 0


@pytest.mark.parametrize("prefix", PREFIXES)
def test_batch_env_step_matches_golden(prefix):
    assert_step_matches_golden(_env("lqr_6_2", 0), golden("lqr"), prefix)


@pytest.mark.parametrize("asset", SIZES)
def test_checked_in_asset_equals_a_fresh_export(asset):
    model_io_tests.test_checked_in_asset_equals_a_fresh_export(asset)


@pytest.mark.slow
def test_golden_file_equals_what_jax_gives_now():
    gold = golden("lqr")
    fresh = export_tool().make_golden("lqr")
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)
