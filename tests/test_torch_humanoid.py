"""Parity of the port's humanoid slice with the JAX package, in float64.

Inputs come from the golden file (written by tools/export_torch_assets.py):
4 states from a JAX ``BatchEnv.reset``, the same 4 after 40 more control
steps (on the floor, contacts active), and numpy-drawn actions, since
torch cannot reproduce ``jax.random`` draws.  Tolerances: 1e-9 for one
``engine.step``, 1e-8 for one ``BatchEnv.step`` (five substeps); both
paths differ by summation order only.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import PREFIXES, assert_step_matches_golden, \
    export_tool, golden, golden_state, jax_model_from_asset
from dm_control_torch import suite as tsuite
from dm_control_torch.ops import linalg as tlinalg
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics.model import JointType, make_data
from dm_control_torch.rl.control import FIRST, LAST, MID


@pytest.fixture(scope="module")
def gold():
    return golden()


@pytest.fixture(scope="module")
def tenv():
    return tsuite.load_batch("humanoid", "run", device="cpu",
                             dtype=torch.float64, autoreset=False)


def test_engine_step_matches_jax(gold, tenv):
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.physics.model import make_data as jmake_data

    jm = jax_model_from_asset("humanoid")
    # one environment in the air, one on the floor with contacts active
    qpos, qvel, warm, ctrl = (
        np.stack([gold[f"reset_{f}"][0], gold[f"contact_{f}"][0]])
        for f in ("qpos", "qvel", "qacc_warmstart", "actions"))

    @jax.jit
    def jstep(q, v, w, c):
        def one(q, v, w, c):
            d = jmake_data(jm).replace(qpos=q, qvel=v, qacc_warmstart=w,
                                       ctrl=c)
            return jengine.step(jm, d)
        return jax.vmap(one)(q, v, w, c)

    jd = jstep(*(jnp.asarray(x) for x in (qpos, qvel, warm, ctrl)))

    m = tenv.model
    d = make_data(m, 2).replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
        qacc_warmstart=torch.as_tensor(warm), ctrl=torch.as_tensor(ctrl))
    td = tengine.step(m, d)
    for f in ("qpos", "qvel", "qacc", "sensordata", "qacc_warmstart"):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(td.solver_niter.numpy(),
                                  np.asarray(jd.solver_niter))
    # the second environment exercises contacts and several Newton steps
    assert bool((td.contact.dist[1] < 0).any())
    assert int(td.solver_niter[1]) > 1


@pytest.mark.parametrize("prefix", PREFIXES)
def test_batch_env_step_matches_golden(gold, tenv, prefix):
    assert_step_matches_golden(tenv, gold, prefix)


@pytest.mark.slow
def test_golden_file_equals_what_jax_gives_now(gold):
    fresh = export_tool().make_golden("humanoid")
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_reset_draws_valid_penetration_free_states(tenv):
    m = tenv.model
    state, ts = tenv.reset(16, torch.Generator().manual_seed(3))
    qpos = state.data.qpos
    quat = qpos[:, 3:7]
    torch.testing.assert_close(torch.linalg.vector_norm(quat, dim=-1),
                               torch.ones(16, dtype=torch.float64))
    for j in range(m.njnt):
        if m.jnt_limited[j] and m.jnt_type[j] == int(JointType.HINGE):
            q = qpos[:, m.jnt_qposadr[j]]
            lo, hi = m.jnt_range[j]
            assert bool(((q >= lo) & (q <= hi)).all()), j
    d = tengine.fwd_position(m, make_data(m, 16).replace(qpos=qpos))
    assert bool((d.contact.dist >= 0).all())
    assert (ts.step_type == FIRST).all() and (ts.reward == 0).all()
    assert all(torch.isfinite(v).all() for v in ts.observation.values())


def test_reset_is_deterministic_per_seed(tenv):
    a, _ = tenv.reset(4, torch.Generator().manual_seed(9))
    b, _ = tenv.reset(4, torch.Generator().manual_seed(9))
    torch.testing.assert_close(a.data.qpos, b.data.qpos, rtol=0, atol=0)


def test_autoreset_replaces_only_finished_envs(gold):
    env = tsuite.load_batch("humanoid", "run", device="cpu",
                            dtype=torch.float64)
    state = golden_state(env, gold, rows=slice(0, 2))
    state = state.replace(needs_reset=torch.tensor([True, False]))
    action = torch.as_tensor(gold["reset_actions"][:2])
    new, ts = env.step(state, action)
    assert ts.step_type.tolist() == [FIRST, MID]
    assert ts.reward[0] == 0 and new.step_count.tolist() == [0, 1]
    np.testing.assert_allclose(new.data.qpos[1].numpy(),
                               gold["reset_step_qpos"][1], rtol=0, atol=1e-8)
    assert not np.allclose(new.data.qpos[0].numpy(), gold["reset_qpos"][0])


def test_divergence_terminates_only_its_env(gold, tenv):
    state = golden_state(tenv, gold, "contact", slice(0, 2))
    qvel = state.data.qvel.clone()
    qvel[0, 0] = float("nan")
    state = state.replace(data=state.data.replace(qvel=qvel))
    new, ts = tenv.step(state, torch.as_tensor(
        gold["contact_actions"][:2]))
    assert ts.step_type.tolist() == [LAST, MID]
    assert ts.reward[0] == 0 and ts.discount.tolist() == [0.0, 1.0]
    assert new.needs_reset.tolist() == [True, False]
    np.testing.assert_allclose(new.data.qpos[1].numpy(),
                               gold["contact_step_qpos"][1], rtol=0,
                               atol=1e-8)


def test_other_domains_are_not_ported():
    """Every suite domain is ported, and what only the composer's models
    bring is too: a ball joint in the humanoid's place of its first hinge
    (the next three joints, whose qpos it takes, made unbounded slides,
    which the randomizer leaves alone) gets a drawn quaternion from the
    randomizer (a bounded one within its range's upper end), where it used
    to raise."""
    from dm_control_torch.rl.control import RandomContext
    from dm_control_torch.suite.utils import randomizers

    m = tsuite.load_batch("humanoid", "run", device="cpu",
                          dtype=torch.float32).model
    slide = (int(JointType.SLIDE),) * 3
    ball = m.replace(
        jnt_type=(m.jnt_type[0], int(JointType.BALL)) + slide
        + m.jnt_type[5:],
        jnt_limited=tuple(m.jnt_limited[:2]) + (False,) * 3
        + tuple(m.jnt_limited[5:]))
    rc = RandomContext(torch.Generator().manual_seed(0), 2, torch.float32)
    qpos = randomizers.randomize_limited_and_rotational_joints(
        ball, m.qpos0.expand(2, m.nq), rc)
    a = m.jnt_qposadr[1]
    quat = qpos[:, a:a + 4]
    torch.testing.assert_close(quat.norm(dim=-1), torch.ones(2))
    angle = 2 * torch.acos(quat[:, 0].clamp(-1, 1))
    assert bool((angle <= m.jnt_range[1, 1] + 1e-6).all())


def test_cpu_run_launches_no_kernel(gold, tenv):
    before = tlinalg.chol_solve.launches
    tenv.step(golden_state(tenv, gold, "contact", slice(0, 1)),
              torch.as_tensor(gold["contact_actions"][:1]))
    assert tlinalg.chol_solve.launches == before
