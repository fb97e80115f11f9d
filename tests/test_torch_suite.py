"""Parity of the port's nine classic-control and planar-locomotion domains
with the JAX package, in float64 on the CPU.

Inputs come from each domain's golden file (tools/export_torch_assets.py):
4 states from a JAX ``BatchEnv.reset``, the same 4 some control steps
later (on the floor, or with ball_in_cup's string taut), the per-episode
model overrides, and numpy-drawn actions, since torch cannot reproduce
``jax.random`` draws.  Tolerances: 1e-9 for one ``engine.step``, 1e-8 for
one ``BatchEnv.step`` (up to ten substeps; the JAX side takes its fused
fast path for six of the domains); the two sides differ by summation
order only.  On the CPU every dense solve is ``chol_solve_reference``.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import PREFIXES, STATE_FIELDS, \
    assert_step_matches_golden, export_tool, golden, golden_state, jax_model
from dm_control_torch import suite as tsuite
from dm_control_torch.ops import linalg as tlinalg
from dm_control_torch.physics import constraints as tcons
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import fastpath as tfastpath
from dm_control_torch.physics.model import make_data
from dm_control_torch.rl.control import FIRST
from dm_control_torch.rl.golden import model_diff

TOOL = export_tool()
#: the nine domains this file holds to their goldens (humanoid, quadruped,
#: fish and swimmer have files of their own)
NEW_DOMAINS = ("pendulum", "acrobot", "cartpole", "reacher", "walker",
               "cheetah", "hopper", "point_mass", "ball_in_cup")
assert set(NEW_DOMAINS) < set(TOOL.DOMAINS)
#: live against JAX in the tier-1 run; the other domains' are ``slow``
LIVE_DOMAINS = ("cartpole", "hopper", "ball_in_cup")
#: the golden environment and later state the live check steps (default:
#: environment 0 at ``contact_*``); hopper's third environment, one control
#: step further on, stands on its heel inside a touch sensor's volume
LIVE_LATER = {"hopper": (2, "contact_step")}


def _env(domain, task=None, **kwargs):
    kwargs.setdefault("autoreset", False)
    return tsuite.load_batch(domain, task or TOOL.GOLDEN_TASKS[domain],
                             device="cpu", dtype=torch.float64, **kwargs)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("domain", NEW_DOMAINS)
def test_batch_env_step_matches_golden(domain, prefix):
    gold = golden(domain)
    env = _env(domain)
    before = tlinalg.chol_solve.launches
    assert_step_matches_golden(env, gold, prefix)
    assert tlinalg.chol_solve.launches == before  # CPU: the plain version


def _engine_step_matches_jax(domain):
    """One ``engine.step`` of both packages from one golden environment's
    reset state and later state; returns the port's model, its Data after
    the step and its Efc before it."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.physics.model import make_data as jmake_data

    gold = golden(domain)
    env = _env(domain)
    asset = next(iter(TOOL.ASSETS[domain]))
    jm = jax_model(asset)
    row, later = LIVE_LATER.get(domain, (0, "contact"))
    qpos, qvel, warm = (
        np.stack([gold[f"reset_{f}"][row], gold[f"{later}_{f}"][row]])
        for f in ("qpos", "qvel", "qacc_warmstart"))
    ctrl = np.stack([gold["reset_actions"][row],
                     gold["contact_actions"][row]])
    later_diff = model_diff(gold, "contact", row)
    diffs = {k: np.stack([v, later_diff[k]])
             for k, v in model_diff(gold, "reset", row).items()}

    @jax.jit
    def jstep(q, v, w, c, diff):
        def one(q, v, w, c, diff):
            d = jmake_data(jm).replace(qpos=q, qvel=v, qacc_warmstart=w,
                                       ctrl=c)
            return jengine.step(jm.replace(**diff), d)
        return jax.vmap(one)(q, v, w, c, diff)

    jd = jstep(*(jnp.asarray(x) for x in (qpos, qvel, warm, ctrl)),
               {k: jnp.asarray(v) for k, v in diffs.items()})

    m = env.model.replace(**{k: torch.as_tensor(v)
                             for k, v in diffs.items()})
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
    fwd = tengine.fwd_velocity(m, tengine.fwd_position(m, d))
    return m, td, tcons.make_constraint(m, fwd)


@pytest.mark.parametrize("domain", LIVE_DOMAINS)
def test_engine_step_matches_jax(domain):
    m, td, efc = _engine_step_matches_jax(domain)
    if domain == "cartpole":  # RK4; contacts off, the slider's limit rows
        assert m.opt.integrator == 1 and efc.nefc == 2
    if domain == "hopper":  # on the floor: contacts, limits, touch
        assert bool((td.contact.dist[1] < 0).any())
        assert int(td.solver_niter[1]) > 1
        assert float(td.sensordata[1, 3:].sum()) > 0
    if domain == "ball_in_cup":  # string taut: its upper limit row active
        assert bool(efc.D[1, 1] > 0) and bool(efc.pos[1, 1] < 0)
        assert int(td.solver_niter[1]) >= 1


@pytest.mark.slow
@pytest.mark.parametrize("domain", [d for d in NEW_DOMAINS
                                    if d not in LIVE_DOMAINS])
def test_engine_step_matches_jax_other_domains(domain):
    _engine_step_matches_jax(domain)


@pytest.mark.slow
@pytest.mark.parametrize("domain", NEW_DOMAINS)
def test_golden_file_equals_what_jax_gives_now(domain):
    gold = golden(domain)
    fresh = TOOL.make_golden(domain)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


# -- per-episode model overrides with a batch axis ---------------------------


def _act(state, rows):
    """The activations of ``rows`` (None where the model has none)."""
    return None if state.data.act is None else state.data.act[rows]


# quadruped's accelerations reach several hundred, so its 1e-13 is relative
# to each field's largest entry (a batch of one takes other BLAS paths than
# a batch of two); it first falls for 30 control steps, onto its terrain
@pytest.mark.parametrize("domain,task,field,rtol,fall", [
    ("reacher", "easy", "geom_pos", 0, 0),
    ("point_mass", "hard", "wrap_prm", 0, 0),
    ("quadruped", "escape", "hfield_data", 1e-13, 30)])
def test_batched_model_diff_equals_single_environment_runs(domain, task,
                                                           field, rtol, fall):
    def close(got, want, what):
        atol = 1e-13 + rtol * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=what)

    env = _env(domain, task)
    state, _ = env.reset(2, _gen(5))
    for _ in range(fall):
        state, _ = env.step(state, torch.zeros(2, env.model.nu,
                                               dtype=torch.float64))
    diff = state.model_diff[field]
    assert diff.shape[0] == 2 and not torch.equal(diff[0], diff[1])
    action = torch.as_tensor(np.random.default_rng(3).uniform(
        -1, 1, (2, env.model.nu)))
    both, ts = env.step(state, action)
    for i in range(2):
        rows = slice(i, i + 1)
        one = env.from_state(
            *(getattr(state.data, f)[rows] for f in STATE_FIELDS),
            generator=_gen(0), model_diff={field: diff[rows]},
            act=_act(state, rows))
        alone, ts1 = env.step(one, action[rows])
        for f in STATE_FIELDS:
            close(getattr(alone.data, f), getattr(both.data, f)[rows], f)
        for k, v in ts1.observation.items():
            close(v, ts.observation[k][rows], k)
        close(ts1.reward, ts.reward[rows], "reward")
    # the two environments did not share one override
    wrong = env.from_state(
        *(getattr(state.data, f)[1:] for f in STATE_FIELDS),
        generator=_gen(0), model_diff={field: diff[:1]},
        act=_act(state, slice(1, None)))
    wrong_state, wrong_ts = env.step(wrong, action[1:])
    moved = (wrong_state.data.qvel - both.data.qvel[1:]).abs().max() \
        + sum((v - ts.observation[k][1:]).abs().max()
              for k, v in wrong_ts.observation.items())
    assert float(moved) > 1e-6


def test_autoreset_keeps_the_other_environments_model_diff():
    env = _env("reacher", "easy", autoreset=True)
    state, _ = env.reset(2, _gen(5))
    target = state.model_diff["geom_pos"].clone()
    state = state.replace(needs_reset=torch.tensor([True, False]))
    new, ts = env.step(state, torch.zeros(2, env.model.nu,
                                          dtype=torch.float64))
    assert ts.step_type[0] == FIRST
    assert torch.equal(new.model_diff["geom_pos"][1], target[1])
    assert not torch.equal(new.model_diff["geom_pos"][0], target[0])


def test_model_diff_refuses_other_fields():
    from dm_control_torch.rl.control import apply_model_diff

    m = _env("reacher", "easy").model
    with pytest.raises(ValueError, match="geom_pos"):
        apply_model_diff(m, {"geom_size": m.geom_size})


# -- the env layer's new branches ---------------------------------------------


def test_cheetah_reset_settles_200_steps_and_zeroes_time(monkeypatch):
    env = _env("cheetah")
    # cheetah takes the fused fast path: the settle steps are steps of
    # FastStep, none of engine.step
    assert env._fast is not None
    calls, engine_calls = [], []
    real_plain = tfastpath.FastStep.plain
    real_step = tengine.step

    def plain(self, qpos, qvel, warm, ctrl, n_steps=1):
        calls.append(n_steps)
        return real_plain(self, qpos, qvel, warm, ctrl, n_steps)

    monkeypatch.setattr(tfastpath.FastStep, "plain", plain)
    monkeypatch.setattr(tengine, "step",
                        lambda m, d: engine_calls.append(1)
                        or real_step(m, d))
    state, ts = env.reset(2, _gen(1))
    assert sum(calls) == env.task.settle_steps == 200
    assert not engine_calls
    assert torch.equal(state.data.time, torch.zeros(2, dtype=torch.float64))
    # settled: resting on the floor, nearly still
    d = tengine.fwd_position(env.model, env._unstrip(state.data))
    assert bool((d.contact.dist < 0).any(-1).all())
    assert float(state.data.qvel.abs().max()) < 1.0
    assert (ts.step_type == FIRST).all()


def test_hopper_observation_has_touch_from_the_acc_branch():
    gold = golden("hopper")
    env = _env("hopper")
    assert env.task.observation_stages == "acc"
    _, ts0 = env.reset(2, _gen(2))
    assert ts0.observation["touch"].shape == (2, 2)
    assert bool((ts0.observation["touch"] == 0).all())  # no force yet
    _, ts = env.step(golden_state(env, gold, "contact"),
                     torch.as_tensor(gold["contact_actions"]))
    assert list(ts.observation) == ["position", "velocity", "touch"]
    assert float(ts.observation["touch"].max()) > 0


@pytest.mark.parametrize("domain", ["acrobot", "pendulum"])
def test_zero_constraint_rows(domain):
    env = _env(domain)
    m = env.model
    state, _ = env.reset(3, _gen(4))
    d = tengine.forward(m, env._unstrip(state.data))
    efc = tcons.make_constraint(m, d)
    assert efc.nefc == 0 and efc.J.shape == (3, 0, m.nv)
    assert torch.equal(d.qacc, d.qacc_smooth)
    assert d.contact.dist.shape == (3, 0)  # nothing is collided
    assert bool((d.solver_niter == 0).all())
    new, ts = env.step(state, torch.zeros(3, m.nu, dtype=torch.float64))
    assert bool(torch.isfinite(new.data.qpos).all())


@pytest.mark.parametrize("domain,task", [
    t for t in tsuite.ALL_TASKS  # cheetah: see above; dog: test_torch_dog.py
    if t[0] not in ("cheetah", "dog")])
def test_every_task_resets_and_steps(domain, task):
    env = _env(domain, task, autoreset=True)
    state, ts = env.reset(2, _gen(0))
    assert (ts.step_type == FIRST).all()
    state, ts = env.step(state, torch.zeros(2, env.model.nu,
                                            dtype=torch.float64))
    assert ts.reward.shape == (2,)
    # lqr's reward is 1 less a quadratic cost: at most 1, unbounded below
    low = -float("inf") if domain == "lqr" else 0.0
    assert bool(((ts.reward >= low) & (ts.reward <= 1)).all())
    assert all(v.shape[0] == 2 and bool(torch.isfinite(v).all())
               for v in ts.observation.values())


def test_tasks_time_limits_and_timesteps_equal_the_jax_suite():
    import inspect

    from dm_control_tpu import suite as jsuite

    for name, domain in tsuite.DOMAINS.items():
        jdomain = jsuite._DOMAINS[name]
        assert tuple(domain.TASKS) == tuple(jdomain.SUITE), name
        for task in domain.TASKS:
            limit = inspect.signature(jdomain.SUITE[task]).parameters[
                "time_limit"].default
            assert domain.TIME_LIMIT == limit, (name, task)
        assert domain.CONTROL_TIMESTEP == getattr(
            jdomain, "_CONTROL_TIMESTEP", None), name


def test_load_batch_errors():
    from dm_control_torch.physics import sensors as tsens
    from dm_control_torch.physics.model import SensorType

    # every domain loads; a sensor type the JAX package does not compute
    # raises, and says so
    m = tsuite.load_batch("humanoid_CMU", "stand", device="cpu",
                          dtype=torch.float32).model
    actuatorfrc = m.replace(sensor_type=(int(SensorType.ACTUATORFRC),)
                            + m.sensor_type[1:])
    with pytest.raises(NotImplementedError,
                       match="no computation in the JAX package"):
        tsens.sensor_pos(actuatorfrc, make_data(actuatorfrc, 1))
    with pytest.raises(ValueError, match="Level 'fly'"):
        tsuite.load_batch("walker", "fly", device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="does not exist"):
        tsuite.load_batch("unicycle", "ride", device="cpu",
                          dtype=torch.float32)
