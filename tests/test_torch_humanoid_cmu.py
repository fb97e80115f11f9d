"""The port's humanoid_CMU path against the JAX package, in float64 on the
CPU: contact compaction, the three tasks and one ``BatchEnv.step`` of the
golden.

Contact compaction on a small model compiled from a few lines of MJCF (a
box lying flat on a plane, its four corners at one depth, and spheres; a
condim-3 group above the cap, a condim-6 group under it):
the port's ``_contact_rows_compact`` against the JAX package's, called
directly in float64 with a cap of 2, from the same states: the selected
candidates equal and in the same order (ties to the lower index), the
rows within 1e-12, and the solve's contact forces, scattered back to the
candidates, within 1e-12 of their largest entry.  ``BatchEnv``'s rule for
the cap, and a float32 CMU step that compacts.  Then the CMU model
(the JAX model built from the checked-in asset): the three tasks'
observation, reward and termination within 1e-10 on the same states
(tests/test_torch_tasks.py's comparison, the JAX task reading the port's
Data after its observe; the golden steps hold that physics to JAX's), one
``BatchEnv.step`` against the golden (``dm_control_torch/rl/golden.py``'s
gate).  Marked ``slow``: the golden equals a fresh JAX run, the asset a
fresh export.
"""

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
from dm_control_torch.physics import solver as tsolver
from dm_control_torch.physics.model import make_data

B = 3
CAP = 2
ATOL = 1e-12

COMPACT_XML = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" conaffinity="3"/>
    <body name="box" pos="0 0 0.098">
      <freejoint name="box"/>
      <geom name="box" type="box" size=".1 .1 .1"/>
    </body>
    <body name="a" pos="0.5 0 0.099">
      <freejoint name="a"/>
      <geom name="a" type="sphere" size=".1"/>
    </body>
    <body name="b" pos="0 0.5 0.1005">
      <freejoint name="b"/>
      <geom name="b" type="sphere" size=".1"/>
    </body>
    <body name="c" pos="0.5 0.5 0.0985">
      <freejoint name="c"/>
      <geom name="c" type="sphere" size=".1" condim="6" contype="2"
            conaffinity="2"/>
    </body>
  </worldbody>
</mujoco>
"""


def _compact_both():
    """The port's and the JAX package's compacted rows and solve at B
    states: environment 0 at rest at the model's pose (the box flat: four
    tied corners), the others moved a little."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu import mjcf
    from dm_control_tpu.physics import constraints as jcons
    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.physics import solver as jsolver
    from dm_control_tpu.physics.model import make_data as jmake_data

    jm = mjcf.compile_xml_string(COMPACT_XML)
    m = model_io.from_jax_model(jm)
    rng = np.random.default_rng(3)
    qpos = np.asarray(jm.qpos0)[None].repeat(B, 0)
    qpos[1:] += 1e-3 * rng.normal(size=qpos[1:].shape)
    qvel = rng.normal(size=(B, m.nv))
    qvel[0] = 0.0

    def pre(engine, m, d):
        d = engine.fwd_velocity(m, engine.fwd_position(m, d))
        return engine.fwd_acceleration(m, engine.fwd_actuation(m, d))

    def jone(q, v):
        d = pre(jengine, jm, jmake_data(jm).replace(qpos=q, qvel=v))
        blocks = jcons._Blocks(jm, d.qpos.dtype)
        spans, selids = jcons._contact_rows_compact(jm, d, blocks, CAP)
        efc = blocks.build((), (), spans, selids)
        out = jsolver.solve(jm, d, efc)
        return efc, out

    jefc, jout = jax.jit(jax.vmap(jone))(jnp.asarray(qpos),
                                          jnp.asarray(qvel))
    d = pre(tengine, m, make_data(m, B).replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
    blocks = tcons._Blocks(m, B)
    efc = blocks.build(sel=tcons._contact_rows_compact(m, d, blocks, CAP))
    return d, efc, tsolver.solve(m, d, efc), jefc, jout


def test_contact_rows_compact_matches_jax():
    d, efc, out, jefc, jout = _compact_both()
    assert efc.sel_spans == jefc.sel_spans
    dims = d.contact.dim
    assert any(dims.count(c) > CAP for c in set(dims))  # some group is cut
    assert any(dims.count(c) <= CAP for c in set(dims))  # and one is not
    sel = efc.contact_selids.numpy()
    np.testing.assert_array_equal(sel, np.asarray(jefc.contact_selids))
    # environment 0's box corners tie: the lower indices come first
    dist0 = d.contact.dist[0].numpy()
    first = efc.sel_spans[0]
    picked = sel[0, first[0]:first[0] + first[3]]
    assert dist0[picked[0]] == dist0[picked[1]] and picked[0] < picked[1]
    assert efc.kind == tuple(jefc.kind)
    for f in ("J", "D", "aref", "pos"):
        np.testing.assert_allclose(getattr(efc, f).numpy(),
                                   np.asarray(getattr(jefc, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    for f in ("contact_force", "contact_force_vec", "qacc"):
        want = np.asarray(getattr(jout, f))
        np.testing.assert_allclose(getattr(out, f).numpy(), want, rtol=0,
                                   atol=ATOL * float(np.abs(want).max()),
                                   err_msg=f)
    # the candidates left out carry no force, the chosen ones do
    force = out.contact_force.numpy()
    left_out = np.ones(force.shape, bool)
    np.put_along_axis(left_out, sel, False, axis=1)
    assert (force[left_out] == 0).all() and (force > 0).any()


def test_batch_env_contact_cap_rule():
    def cap(dtype, **kw):
        return tsuite.load_batch("humanoid_CMU", "run", device="cpu",
                                 dtype=dtype, **kw).model.opt.contact_cap

    assert cap(torch.float32) == 64  # 1,157 candidates
    assert cap(torch.float64) == 0
    assert cap(torch.float32, contact_cap=0) == 0
    assert cap(torch.float64, contact_cap=16) == 16
    assert tsuite.load_batch("humanoid", "run", device="cpu",
                             dtype=torch.float32).model.opt.contact_cap == 0


def test_float32_step_compacts():
    """A float32 CMU step keeps 64 contacts of its 1,157 and stays finite."""
    env = tsuite.load_batch("humanoid_CMU", "run", device="cpu",
                            dtype=torch.float32)
    state, _ = env.reset(2, torch.Generator().manual_seed(1))
    m = env.model
    d = tengine.fwd_acceleration(m, tengine.fwd_actuation(
        m, tengine.fwd_velocity(m, tengine.fwd_position(
            m, env._unstrip(state.data)))))
    efc = tcons.make_constraint(m, d)
    assert len(d.contact.dim) == 1157
    assert efc.sel_spans == ((0, efc.nefc - 64 * 4, 4, 64),)
    state, ts = env.step(state, torch.zeros(2, m.nu))
    assert all(bool(torch.isfinite(v).all())
               for v in ts.observation.values())


# -- the CMU model and tasks --------------------------------------------------


@pytest.fixture(scope="module")
def jax_cmu():
    """The JAX CMU model, built from the checked-in asset (a JAX compile
    takes half a minute here)."""
    from _torch_helpers import jax_model_from_asset

    return jax_model_from_asset("humanoid_CMU")


@pytest.mark.parametrize("task,speed", [("stand", 0), ("walk", 1),
                                        ("run", 10)])
def test_task_functions_match_jax(task, speed, jax_cmu):
    from dm_control_tpu.rl.batch_env import BatchEnv
    from dm_control_tpu.suite.humanoid_CMU import HumanoidCMU

    env = BatchEnv(jax_cmu, HumanoidCMU(speed), autoreset=False,
                   contact_cap=0)
    tasks.test_task_functions_match_jax("humanoid_CMU", task, jax_env=env,
                                        jax_physics=False)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_batch_env_step_matches_golden(prefix):
    env = tsuite.load_batch("humanoid_CMU", "run", device="cpu",
                            dtype=torch.float64, autoreset=False)
    assert_step_matches_golden(env, golden("humanoid_CMU"), prefix)


@pytest.mark.slow
def test_checked_in_asset_equals_a_fresh_export():
    import test_torch_model_io as model_io_tests

    model_io_tests.test_checked_in_asset_equals_a_fresh_export(
        "humanoid_CMU")


@pytest.mark.slow
def test_golden_file_equals_what_jax_gives_now():
    gold = golden("humanoid_CMU")
    fresh = export_tool().make_golden("humanoid_CMU")
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)
