"""The port's fused fast path (dm_control_torch/physics/fastpath.py)
against the JAX package's (dm_control_tpu/physics/fastpath.py), on the CPU
in float64, with inputs made from a seed with numpy.

Gates: qpos within 1e-12 and qvel within 1e-10 (as tests/test_fastpath.py
holds JAX's fast path to its general engine), and the solver's warm start
within 1e-10 of max(1, its largest entry).  The contact models (cheetah,
walker) are held to a checked-in recording of JAX's ``build_step``
(``tests/data/torch_fastpath_contacts_f64.npz``, written by
``tools/export_torch_assets.py fastpath_golden``): a fresh JAX compile of
their step takes 30-130 s on a CPU, so the check that the recording equals
a fresh JAX run is in the slow tier.  The JAX models are the port's
checked-in assets held field by field in a JAX ``Model``
(``_torch_helpers.jax_model_from_asset``), not fresh MJCF compiles.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import ROOT, export_tool, jax_model_from_asset, \
    jax_model_from_port
from dm_control_torch import mjcf
from dm_control_torch import suite as tsuite
from dm_control_torch.physics import collision
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import fastpath as tfastpath
from dm_control_torch.physics.model import make_data
from dm_control_torch.rl.batch_env import BatchEnv
from dm_control_torch.suite import base as tbase
from dm_control_tpu.physics import fastpath as jfastpath

QPOS_TOL, QVEL_TOL, WARM_TOL = 1e-12, 1e-10, 1e-10
#: the six models the JAX BatchEnv takes its fast path for, and five it
#: does not (a tendon, touch sensors, frame sensors, a drawn target's
#: sensors, a string)
FAST_ASSETS = ("pendulum", "cartpole", "cartpole_2", "acrobot",
               "reacher_easy", "walker", "cheetah")
OTHER_ASSETS = ("point_mass", "hopper", "swimmer6", "finger", "ball_in_cup")
FAST_TASKS = (("pendulum", "swingup"), ("cartpole", "swingup"),
              ("acrobot", "swingup"), ("reacher", "easy"), ("walker", "run"),
              ("cheetah", "run"))

#: every collider of the kernel once (tests/data/torch_fastpath_colliders.xml)
COLLIDER_XML = open(os.path.join(ROOT, "tests", "data",
                                 "torch_fastpath_colliders.xml")).read()


def _port_model(asset):
    return tbase.load_model(asset, "cpu", torch.float64)


def _assert_state_close(got, want, what):
    qpos, qvel, warm = (np.asarray(x) for x in got)
    np.testing.assert_allclose(qpos, want[0], rtol=0, atol=QPOS_TOL,
                               err_msg=f"{what}: qpos")
    np.testing.assert_allclose(qvel, want[1], rtol=0, atol=QVEL_TOL,
                               err_msg=f"{what}: qvel")
    scale = max(1.0, float(np.abs(want[2]).max()))
    np.testing.assert_allclose(warm, want[2], rtol=0, atol=WARM_TOL * scale,
                               err_msg=f"{what}: warm start")


# -- (a) applicable -----------------------------------------------------------


@pytest.mark.parametrize("asset", FAST_ASSETS + OTHER_ASSETS)
def test_applicable_equals_jax(asset):
    want = jfastpath.applicable(jax_model_from_asset(asset))
    assert tfastpath.applicable(_port_model(asset)) == want
    assert want == (asset in FAST_ASSETS)


BOX_XML = """
<mujoco>
  <worldbody>
    <geom type="plane" size="2 2 0.1"/>
    <body pos="0 0 0.2">
      <joint type="slide" axis="1 0 0"/>
      <joint type="slide" axis="0 0 1"/>
      <joint type="hinge" axis="0 1 0"/>
      <geom type="box" size="0.1 0.1 0.1" mass="1"/>
    </body>
  </worldbody>
</mujoco>
"""


def test_plane_box_pair_is_refused_for_its_collider_only():
    """A scalar-joint model whose one pair is PLANE-BOX: JAX's rule takes
    it, the port's refuses it (the kernel has no box collider), so it runs
    engine.step; the same model with a capsule for its box is taken."""
    m = mjcf.compile_xml_string(BOX_XML, device="cpu")
    assert [k for k, _, _ in collision.contact_groups(m)] == [
        (tfastpath.GeomType.PLANE, tfastpath.GeomType.BOX)]
    assert jfastpath.applicable(jax_model_from_port(m))
    assert not tfastpath.applicable(m)
    assert tfastpath.build_step(m) is None
    capsule = mjcf.compile_xml_string(BOX_XML.replace(
        'type="box" size="0.1 0.1 0.1"', 'type="capsule" size="0.1 0.1"'),
        device="cpu")
    assert tfastpath.applicable(capsule)


# -- (b) 40 steps against JAX -------------------------------------------------


def _random_start(m, seed=0, batch=1):
    rng = np.random.RandomState(seed)
    qpos = np.asarray(m.qpos0) + rng.randn(batch, m.nq) * 0.3
    qvel = rng.randn(batch, m.nv) * 0.5
    ctrl = rng.uniform(-1, 1, (batch, m.nu))
    return qpos, qvel, np.zeros((batch, m.nv)), ctrl


def _run_both(m, jm, start, steps):
    """``steps`` steps of the port's plain step and of JAX's jitted
    ``build_step`` from one start; yields both states after each step."""
    step1 = jax.jit(jax.vmap(jfastpath.build_step(jm)))
    fast = tfastpath.build_step(m)
    qpos, qvel, warm, ctrl = start
    jstate = [jnp.asarray(x) for x in (qpos, qvel, warm)]
    tstate = [torch.as_tensor(x) for x in (qpos, qvel, warm)]
    jctrl, tctrl = jnp.asarray(ctrl), torch.as_tensor(ctrl)
    for _ in range(steps):
        jstate = list(step1(*jstate, jctrl))
        tstate = list(fast(*tstate, tctrl))
        yield tstate, [np.asarray(x) for x in jstate]


@pytest.mark.parametrize("asset", ["pendulum", "cartpole", "cartpole_2",
                                   "acrobot", "reacher_easy"])
def test_40_steps_match_jax(asset):
    m = _port_model(asset)
    for i, (got, want) in enumerate(_run_both(
            m, jax_model_from_asset(asset), _random_start(m), 40)):
        _assert_state_close(got, want, f"{asset} step {i}")


# -- (c) the contact models against the recording ---------------------------


@pytest.fixture(scope="module")
def recording():
    with np.load(export_tool().fastpath_golden_path()) as z:
        return {k: z[k] for k in z.files}


def _active_contact_rows(fast, qpos, qvel, ctrl, limits=False):
    """Contact rows (or with ``limits``, limit rows) with force (D > 0) at
    a state, per environment."""
    c = fast._c(torch.float64, torch.device("cpu"))
    _, _, _, ctx = fast._smooth(qpos, qvel, ctrl, c)
    _, _, D = fast._rows(qpos, qvel, ctx, c)
    n = len(fast.lims)
    return ((D[:, :n] if limits else D[:, n:]) > 0).sum(1)


@pytest.mark.parametrize("asset", ["cheetah", "walker"])
@pytest.mark.parametrize("prefix", ["reset", "contact"])
def test_contact_models_match_the_jax_recording(recording, asset, prefix):
    """Each recorded step of JAX's ``build_step``, from the recorded state
    before it (a step of a contact-rich model moves with rounding where
    contacts start or end, so each starts from JAX's own state)."""
    fast = tfastpath.build_step(_port_model(asset))
    tag = f"{asset}_{prefix}_"
    qpos, qvel, warm = (torch.as_tensor(recording[tag + f])
                        for f in ("qpos", "qvel", "warm"))
    ctrl = torch.as_tensor(recording[tag + "ctrl"])
    active = _active_contact_rows(fast, qpos[0], qvel[0], ctrl)
    if prefix == "contact" or asset == "cheetah":  # on the floor
        assert int(active.sum()) > 0, active
    for t in range(qpos.shape[0] - 1):
        got = fast(qpos[t], qvel[t], warm[t], ctrl)
        _assert_state_close([x.numpy() for x in got],
                            [x[t + 1].numpy() for x in (qpos, qvel, warm)],
                            f"{tag}step {t}")


@pytest.mark.slow
def test_recording_equals_a_fresh_jax_run(recording):
    fresh = export_tool().make_fastpath_golden()
    assert set(fresh) == set(recording)
    for k, v in fresh.items():
        np.testing.assert_allclose(recording[k], v, rtol=0, atol=1e-12,
                                   err_msg=k)


# -- (d) the five colliders ---------------------------------------------------


def test_five_colliders_match_jax():
    m = mjcf.compile_xml_string(COLLIDER_XML, device="cpu")
    keys = [k for k, _, _ in collision.contact_groups(m)]
    assert sorted(keys) == sorted(tfastpath.COLLIDERS)
    fast = tfastpath.build_step(m)
    rng = np.random.default_rng(0)
    batch = 3
    qpos = np.asarray(m.qpos0)[None] + rng.normal(0, 0.005, (batch, m.nq))
    start = (qpos, rng.normal(0, 0.2, (batch, m.nv)),
             np.zeros((batch, m.nv)), rng.uniform(-1, 1, (batch, m.nu)))
    active = _active_contact_rows(fast, *(torch.as_tensor(start[k])
                                          for k in (0, 1, 3)))
    assert bool((active > 0).all()), active
    for i, (got, want) in enumerate(_run_both(m, jax_model_from_port(m),
                                              start, 40)):
        _assert_state_close(got, want, f"colliders step {i}")


# -- (e) the rail limit -------------------------------------------------------


def test_rail_limit_matches_engine_step():
    """Cartpole pushed into its rail limit from near the rail's end: the
    Newton solve with an active limit row against the port's engine.step,
    within 1e-9, as tests/test_fastpath.py holds JAX's."""
    env = tsuite.load_batch("cartpole", "swingup", device="cpu",
                            dtype=torch.float64)
    m = env.model
    fast = tfastpath.build_step(m)
    d = make_data(m, 1)
    qpos = d.qpos.clone()
    qpos[0, 0] = float(m.jnt_range[0, 1]) - 0.2  # the cart 0.2 from its end
    d = d.replace(qpos=qpos, ctrl=torch.ones(1, m.nu, dtype=torch.float64))
    qpos, qvel, warm = d.qpos, d.qvel, d.qacc_warmstart
    active = 0
    for _ in range(400):
        d = tengine.step(m, d)
        d = d.replace(qacc_warmstart=d.qacc)
        qpos, qvel, warm = fast(qpos, qvel, warm, d.ctrl)
        np.testing.assert_allclose(qpos.numpy(), d.qpos.numpy(), rtol=0,
                                   atol=1e-9)
        # steps whose next step has a limit row with force (D > 0)
        active += _active_contact_rows(fast, qpos, qvel, d.ctrl,
                                       limits=True) > 0
        if active >= 20:
            break
    assert active >= 20, "the cart never reached its rail limit"


# -- (f) the pivot clamp ------------------------------------------------------


def test_chol_solve_clamps_the_pivot_of_a_singular_system():
    M = np.array([[4.0, 2.0, 2.0], [2.0, 1.0, 1.0], [2.0, 1.0, 3.0]])
    rhs = np.array([1.0, 1.0, 2.0])
    got = tfastpath._chol_solve(torch.as_tensor(M)[None],
                                torch.as_tensor(rhs)[None])[0].numpy()
    want = np.asarray(jfastpath._chol_solve(
        [[jnp.asarray(x) for x in row] for row in M],
        [jnp.asarray(x) for x in rhs], 3))
    assert np.isfinite(got).all()
    # the second pivot is 0 and clamps to sqrt(1e-15)
    assert abs(got).max() > 1e6
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# -- (g) BatchEnv -------------------------------------------------------------


@pytest.mark.parametrize("domain,task", FAST_TASKS)
def test_batch_env_takes_the_fast_path(domain, task):
    env = tsuite.load_batch(domain, task, device="cpu", dtype=torch.float64)
    assert env._fast is not None


def test_dynamics_diff_turns_the_fast_path_off():
    env = tsuite.load_batch("cartpole", "swingup", device="cpu",
                            dtype=torch.float64)

    class DampingDiff(type(env.task)):
        def initial_model_diff(self, m):
            return {"dof_damping": m.dof_damping}

    task = DampingDiff.__new__(DampingDiff)
    task.__dict__.update(env.task.__dict__)
    assert BatchEnv(env.model, task)._fast is None


def test_reacher_target_diff_matches_the_general_engine():
    """Reacher's drawn target is a per-episode geom_pos diff: the fast
    path stays on, and 20 control steps of observations and rewards equal
    those of the same BatchEnv without it within 1e-12."""
    envs = [tsuite.load_batch("reacher", "easy", device="cpu",
                              dtype=torch.float64) for _ in range(2)]
    assert envs[0]._fast is not None
    envs[1]._fast = None
    before = tfastpath.fastpath_step_cuda.launches
    out = []
    for env in envs:
        state, ts = env.reset(4, torch.Generator().manual_seed(2))
        rng = np.random.RandomState(2)
        steps = [ts]
        for _ in range(20):
            state, ts = env.step(state, torch.as_tensor(
                rng.uniform(-1, 1, (4, env.model.nu))))
            steps.append(ts)
        out.append(steps)
    # on the CPU the plain version runs: no kernel launch is counted
    assert tfastpath.fastpath_step_cuda.launches == before
    for fast_ts, plain_ts in zip(*out):
        assert list(fast_ts.observation) == list(plain_ts.observation)
        for k in fast_ts.observation:
            np.testing.assert_allclose(fast_ts.observation[k].numpy(),
                                       plain_ts.observation[k].numpy(),
                                       rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(fast_ts.reward.numpy(),
                                   plain_ts.reward.numpy(), rtol=0,
                                   atol=1e-12)
