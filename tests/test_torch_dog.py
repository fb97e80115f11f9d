"""The port's dog path against the JAX package, in float64 on the CPU: the
noslip post-pass, the SUBTREEANGMOM sensor, the five dog tasks and one
``BatchEnv.step`` of each dog golden.

Unit checks on small models compiled from a few lines of MJCF: the noslip
sweep (boxes and a sphere resting on a plane, condim 3 and 6, one hinge
with friction loss) from the same Newton solution and constraint rows
against ``jax.vmap`` of the JAX package's ``_noslip`` within 1e-12, over
one and over four sweeps; the port's gathered sweep equal to its full
sweep bit for bit; a whole ``solve`` with noslip against the JAX solve
within 1e-12 of each field's largest entry (it differs from the solve
without noslip by far more, so a skipped sweep fails); SUBTREEANGMOM on a
small tree within 1e-12.  Then the dog models (the JAX models built from the
checked-in assets through a module-scoped fixture: a JAX compile of each
takes most of a minute here): the five tasks' observation, reward and
termination within 1e-10 on the same states (tests/test_torch_tasks.py's
comparison, the JAX task reading the port's Data after the "acc" observe:
the JAX physics of 6,940 candidates takes minutes to compile here, and
the golden steps hold that physics to JAX's; the four no-ball tasks share
one model, since they differ only in the floor's size, which none of them
reads), one ``BatchEnv.step`` against the goldens
(``dm_control_torch/rl/golden.py``'s gate).  Marked ``slow``: the goldens
equal a fresh JAX run, the two assets a fresh export, and trot's and
run's models the JAX compiles of their floors.
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_tasks as tasks
from _torch_helpers import PREFIXES, assert_step_matches_golden, \
    export_tool, golden
from dm_control_torch import suite as tsuite
from dm_control_torch.physics import constraints as tcons
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import model_io
from dm_control_torch.physics import sensors as tsens
from dm_control_torch.physics import solver as tsolver
from dm_control_torch.physics.model import make_data

ATOL = 1e-12
B = 3

NOSLIP_XML = """
<mujoco>
  <option timestep="0.005" noslip_iterations="{iterations}"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body name="box" pos="0 0 0.099">
      <freejoint name="box"/>
      <geom name="box" type="box" size=".1 .1 .1"/>
    </body>
    <body name="box2" pos="0 0.5 0.098">
      <freejoint name="box2"/>
      <geom name="box2" type="box" size=".1 .1 .1"/>
    </body>
    <body name="ball" pos="0.5 0 0.098">
      <freejoint name="ball"/>
      <geom name="ball" type="sphere" size=".1" condim="6"/>
    </body>
    <body name="arm" pos="-0.6 0 0.3">
      <joint name="hinge" type="hinge" axis="0 1 0" frictionloss="0.05"/>
      <geom name="arm" type="capsule" fromto="0 0 0 0.2 0 -0.26"
            size="0.05"/>
    </body>
  </worldbody>
</mujoco>
"""

TREE_XML = """
<mujoco>
  <worldbody>
    <body name="root" pos="0 0 1">
      <freejoint name="root"/>
      <geom name="root" type="box" size=".2 .1 .05" mass="3"/>
      <body name="upper" pos="0.2 0 0">
        <joint name="upper" type="hinge" axis="0 1 0"/>
        <geom name="upper" type="capsule" fromto="0 0 0 0.3 0 0"
              size="0.04"/>
        <body name="lower" pos="0.3 0 0">
          <joint name="lower" type="hinge" axis="0 0 1"/>
          <geom name="lower" type="capsule" fromto="0 0 0 0 0.25 0"
                size="0.03"/>
        </body>
      </body>
      <body name="side" pos="-0.2 0 0">
        <joint name="side" type="hinge" axis="1 0 0"/>
        <geom name="side" type="ellipsoid" size="0.1 0.05 0.03"/>
      </body>
    </body>
  </worldbody>
  <sensor>
    <subtreeangmom name="root" body="root"/>
    <subtreelinvel name="upper_linvel" body="upper"/>
    <subtreeangmom name="upper" body="upper"/>
    <subtreeangmom name="lower" body="lower"/>
    <subtreeangmom name="side" body="side"/>
  </sensor>
</mujoco>
"""


def _models(xml):
    """(port model, JAX model) of an MJCF string, float64."""
    from dm_control_tpu import mjcf

    jm = mjcf.compile_xml_string(xml)
    return model_io.from_jax_model(jm), jm


def _states(m, scale=1.0):
    """B states from a numpy seed: qpos0 plus a small draw, velocities
    drawn (the bodies slide and spin on the floor)."""
    rng = np.random.default_rng(5)
    qpos = np.asarray(m.qpos0.numpy())[None].repeat(B, 0)
    qpos = qpos + scale * 1e-3 * rng.normal(size=qpos.shape)
    qvel = scale * rng.normal(size=(B, m.nv))
    return qpos, qvel


def _pre_solve(engine, m, d):
    d = engine.fwd_velocity(m, engine.fwd_position(m, d))
    return engine.fwd_acceleration(m, engine.fwd_actuation(m, d))


@functools.lru_cache(maxsize=None)
def _noslip_setup():
    """Both models (4 noslip sweeps), the port's Data before the solve, and
    from one jitted JAX run at the same B states: the JAX Data and rows,
    the Newton solution without noslip, and the whole solve with it."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics import constraints as jcons
    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.physics import solver as jsolver
    from dm_control_tpu.physics.model import make_data as jmake_data

    m, jm = _models(NOSLIP_XML.format(iterations=4))
    qpos, qvel = _states(m)
    jm0 = jm.replace(opt=jm.opt.replace(noslip_iterations=0))

    def jone(q, v):
        d = _pre_solve(jengine, jm, jmake_data(jm).replace(qpos=q, qvel=v))
        efc = jcons.make_constraint(jm, d)
        return d, efc, jsolver.solve(jm0, d, efc).qacc, jsolver.solve(
            jm, d, efc)

    jd, jefc, x, jout = jax.jit(jax.vmap(jone))(jnp.asarray(qpos),
                                                 jnp.asarray(qvel))
    d = _pre_solve(tengine, m, make_data(m, B).replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
    return m, jm, d, jd, jefc, x, jout


def _sweeps(m, jm, iterations):
    """Both models with ``iterations`` noslip sweeps."""
    return (m.replace(opt=m.opt.replace(noslip_iterations=iterations)),
            jm.replace(opt=jm.opt.replace(noslip_iterations=iterations)))


def _port_efc(m, jefc):
    """The JAX rows as the port's ``Efc`` (the same numbers)."""
    kind = np.array(jefc.kind)
    ne, nf = int((kind == 0).sum()), int((kind == 1).sum())
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return tcons.Efc(J=t(jefc.J), D=t(jefc.D), R=t(jefc.R),
                     aref=t(jefc.aref), pos=t(jefc.pos),
                     floss=t(jefc.floss)[0, ne:ne + nf],
                     contact_spans=jefc.contact_spans, ne=ne, nf=nf)


def _jax_force(jm, jd, jefc, x):
    """The JAX Newton forces at x (what ``solve`` hands ``_noslip``)."""
    import jax

    from dm_control_tpu.physics import solver as jsolver

    def one(d, efc, x):
        eq, fl, uni = jsolver._masks(efc)
        _, dcost, _ = jsolver._cost_terms(efc, efc.J @ x - efc.aref, eq, fl,
                                          uni)
        return -dcost

    return jax.vmap(one)(jd, jefc, x)


@pytest.mark.parametrize("iterations", [1, 4])
def test_noslip_matches_jax(iterations):
    import jax

    from dm_control_tpu.physics import solver as jsolver

    m, jm, d, jd, jefc, x, _ = _noslip_setup()
    m, jm = _sweeps(m, jm, iterations)
    f0 = _jax_force(jm, jd, jefc, x)
    jf, jq = jax.vmap(lambda d, efc, x, f: jsolver._noslip(
        jm, d, efc, d.qacc_smooth, x, f))(jd, jefc, x, f0)
    efc = _port_efc(m, jefc)
    assert efc.nf == 1 and {n for _, _, n in efc.contact_spans} == {4, 10}
    tf, tq = tsolver.noslip(m, d.replace(qM=torch.as_tensor(np.array(
        jd.qM))), efc, torch.as_tensor(np.array(x)),
        torch.as_tensor(np.array(f0)))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=ATOL)
    # the sweep moved the friction forces and qacc
    assert float(np.abs(np.asarray(jq) - np.asarray(x)).max()) > 1e-3


def test_gathered_noslip_equals_the_full_sweep():
    m, jm, d, jd, jefc, x, _ = _noslip_setup()
    efc = _port_efc(m, jefc)
    f0 = torch.as_tensor(np.array(_jax_force(jm, jd, jefc, x)))
    d = d.replace(qM=torch.as_tensor(np.array(jd.qM)))
    x = torch.as_tensor(np.array(x))
    tsolver.noslip.slots = 0
    gathered = tsolver.noslip(m, d, efc, x, f0)
    visited = tsolver.noslip.slots
    full = tsolver.noslip(m, d, efc, x, f0, gather=False)
    ncon = sum(len(ids) for ids, _, n in efc.contact_spans if n > 1)
    assert 0 < visited < ncon  # some contacts carry no force
    assert torch.equal(gathered[0], full[0])
    assert torch.equal(gathered[1], full[1])


def test_solve_with_noslip_matches_jax():
    """A whole solve (Newton, noslip, contact forces), each package on its
    own rows; without noslip the port's result is far from JAX's."""
    m, _, d, _, _, _, jout = _noslip_setup()
    efc = tcons.make_constraint(m, d)
    out = tsolver.solve(m, d, efc)
    skipped = tsolver.solve(m.replace(opt=m.opt.replace(
        noslip_iterations=0)), d, efc)
    for f in ("qacc", "qfrc_constraint", "contact_force_vec"):
        want = np.asarray(getattr(jout, f))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(getattr(out, f).numpy(), want, rtol=0,
                                   atol=ATOL * scale, err_msg=f)
        if f == "qacc":
            assert float(np.abs(getattr(skipped, f).numpy() - want).max()) \
                > 1e3 * ATOL * scale


def test_subtreeangmom_matches_jax():
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.physics import sensors as jsens
    from dm_control_tpu.physics.model import make_data as jmake_data

    m, jm = _models(TREE_XML)
    qpos, qvel = _states(m, scale=300.0)

    def jone(q, v):
        d = jengine.fwd_velocity(jm, jengine.fwd_position(
            jm, jmake_data(jm).replace(qpos=q, qvel=v)))
        return jsens.sensor_vel(jm, d).sensordata

    want = jax.jit(jax.vmap(jone))(jnp.asarray(qpos), jnp.asarray(qvel))
    d = make_data(m, B).replace(qpos=torch.as_tensor(qpos),
                                qvel=torch.as_tensor(qvel))
    d = tsens.sensor_vel(m, tengine.fwd_velocity(m, tengine.fwd_position(
        m, d)))
    np.testing.assert_allclose(d.sensordata.numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    assert float(np.abs(np.asarray(want)).min()) > 1e-3  # every value moves


# -- the dog models and tasks -------------------------------------------------


@pytest.fixture(scope="module")
def jax_dogs():
    """The JAX dog models (no ball, floor 15; and fetch's), built from the
    checked-in assets: compiling them takes most of a minute each."""
    from _torch_helpers import jax_model_from_asset

    return {a: jax_model_from_asset(a) for a in ("dog", "dog_fetch")}


#: task -> the JAX task object's constructor
def _jax_task(task):
    from dm_control_tpu.suite import dog as jdog

    return {"stand": lambda: jdog.Stand(), "walk": lambda: jdog.Move(1),
            "trot": lambda: jdog.Move(3), "run": lambda: jdog.Move(9),
            "fetch": lambda: jdog.Fetch()}[task]()


@pytest.mark.parametrize("task", ["stand", "walk", "trot", "run", "fetch"])
def test_task_functions_match_jax(task, jax_dogs):
    from dm_control_tpu.rl.batch_env import BatchEnv

    from dm_control_tpu.suite import dog as jdog

    asset = "dog_fetch" if task == "fetch" else "dog"
    env = BatchEnv(jax_dogs[asset], _jax_task(task), autoreset=False,
                   contact_cap=0)
    jdog._pose_consts(env.model)  # on the host, before a trace reads them
    tasks.test_task_functions_match_jax("dog", task, jax_env=env,
                                        jax_physics=False)


def test_reset_draws_activations_in_the_ctrlrange():
    """``Task.init_act``: every environment starts with its own
    activations, drawn in the actuators' control range."""
    env = tsuite.load_batch("dog", "stand", device="cpu",
                            dtype=torch.float64)
    state, ts = env.reset(4, torch.Generator().manual_seed(3))
    act, cr = state.data.act, env.model.actuator_ctrlrange
    assert act.shape == (4, env.model.na) and env.model.na == env.model.nu
    assert bool(((act >= cr[:, 0]) & (act <= cr[:, 1])).all())
    assert bool((act[0] != act[1]).all())
    assert torch.equal(ts.observation["actuator_state"], act)


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("name,task", [("dog", "run"), ("dog_fetch", "fetch")])
def test_batch_env_step_matches_golden(name, task, prefix):
    env = tsuite.load_batch("dog", task, device="cpu", dtype=torch.float64,
                            autoreset=False)
    assert_step_matches_golden(env, golden(name), prefix)


def test_golden_states_reach_noslip():
    """At the later states of dog:run feet are loaded (touch > 0) in two
    environments, and in one of them the noslip sweep moves qacc by more
    than 1 (of a 7.8e3 scale)."""
    from dm_control_torch.rl.control import apply_model_diff
    from dm_control_torch.rl.golden import start_state

    gold = golden("dog")
    env = tsuite.load_batch("dog", "run", device="cpu", dtype=torch.float64,
                            autoreset=False)
    state = start_state(env, gold, "contact")
    m = apply_model_diff(env.model, state.model_diff)
    d = tengine.forward(m, env.task.before_step(
        m, env._unstrip(state.data), torch.as_tensor(
            gold["contact_actions"])))
    loaded = env.task._touch_sensors(m, d).sum(-1) > 0
    assert int(loaded.sum()) >= 2
    efc = tcons.make_constraint(m, d)
    with_noslip = tsolver.solve(m, d, efc).qacc
    without = tsolver.solve(m.replace(opt=m.opt.replace(
        noslip_iterations=0)), d, efc).qacc
    moved = (with_noslip - without).abs().max(-1).values
    assert bool((loaded & (moved > 1.0)).any())


@pytest.mark.slow
@pytest.mark.parametrize("name", ["dog", "dog_fetch"])
def test_golden_file_equals_what_jax_gives_now(name):
    gold = golden(name)
    fresh = export_tool().make_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("asset", ["dog", "dog_fetch"])
def test_checked_in_asset_equals_a_fresh_export(asset):
    import test_torch_model_io as model_io_tests

    model_io_tests.test_checked_in_asset_equals_a_fresh_export(asset)


@pytest.mark.slow
def test_task_models_differ_from_the_asset_in_the_floor_only():
    """trot's and run's models, the asset with the floor's size edited,
    equal the JAX package's compiles of their floors field by field."""
    import test_torch_model_io as model_io_tests
    from dm_control_tpu.suite import dog as jdog

    for task, half in (("trot", 45), ("run", 135)):
        m = tsuite.load_batch("dog", task, device="cpu", dtype=torch.float64,
                              contact_cap=0).model
        model_io_tests._assert_same(m, model_io.from_jax_model(
            jdog._make_model(half, True)))
