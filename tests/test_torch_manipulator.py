"""The port's manipulator and stacker paths against the JAX package, in
float64 on the CPU: the box colliders on the path, elliptic cones at
hundreds of contacts, and the per-episode ``body_pos`` and ``body_quat``.

From the goldens (tools/export_torch_assets.py: manipulator:bring_ball,
manipulator:insert_peg, stacker:stack_4) one ``BatchEnv.step`` within
1e-8.  For insert_peg and stack_2 the stages within 1e-12, the constraint
rows (equal kinds in equal order; box-box rows at an infinite distance
carried with no force) within 1e-10, one ``engine.step`` within 1e-9 with
equal ``solver_niter``; stack_2's states are built here: a box flat on
the floor and another resting on it.  The arm's light finger links
reach accelerations of 1e5, where 1e-9 absolute asks for 1e-14 relative,
below what float64 keeps through a solve: the step's qacc is held to
1e-12 relative to each state's largest acceleration, its qpos and qvel to
1e-9 absolute.  The six tasks against the JAX package's tasks of the same
names (observation, reward, termination after the "acc" observe branch)
within 1e-10, through tests/test_torch_tasks.py's functions, with state 0
one the task's reward pays for.  Both sides compute the same expressions
and differ in the order of their sums.  The six assets equal a fresh
export, through tests/test_torch_model_io.py's function, here where their
JAX models are compiled anyway.  Marked ``slow``: each golden file equals
a fresh JAX run.
"""

import math

import numpy as np
import pytest
import torch

import test_torch_model_io as model_io_tests
import test_torch_tasks as tasks
from _torch_helpers import PREFIXES, assert_stages_close, \
    assert_step_matches_golden, export_tool, golden, golden_rows, \
    stages_both
from dm_control_torch import suite as tsuite
from dm_control_torch.physics import constraints as tcons
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics.model import GeomType, make_data
from dm_control_torch.rl.control import apply_model_diff
from dm_control_torch.rl.golden import start_state
from dm_control_torch.suite.manipulator import _ARM_JOINTS as ARM_JOINTS

#: golden -> (domain, task)
GOLDENS = {"manipulator": ("manipulator", "bring_ball"),
           "manipulator_insert_peg": ("manipulator", "insert_peg"),
           "stacker": ("stacker", "stack_4")}


def _env(domain, task, autoreset=False):
    return tsuite.load_batch(domain, task, device="cpu", dtype=torch.float64,
                             autoreset=autoreset)


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("name", GOLDENS)
def test_batch_env_step_matches_golden(name, prefix):
    assert_step_matches_golden(_env(*GOLDENS[name]), golden(name), prefix)


@pytest.mark.slow
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_file_equals_what_jax_gives_now(name):
    gold = golden(name)
    fresh = export_tool().make_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def _active(m, d, kind1, kind2):
    """(B, K) of the contacts between geoms of two types: penetrating."""
    cols = [c for c, (g1, g2) in enumerate(zip(d.contact.geom1,
                                               d.contact.geom2))
            if (m.geom_type[g1], m.geom_type[g2]) == (int(kind1),
                                                       int(kind2))]
    assert cols
    return d.contact.dist[:, cols] < 0


def _cone_zones(m, d, efc):
    """(sticking, sliding) counts of the elliptic contacts at the solved
    qacc, the solver's zones."""
    jar = torch.einsum("bkv,bv->bk", efc.J, d.qacc) - efc.aref
    stick = slide = 0
    for conids, start, dim in efc.cone_spans:
        k = len(conids)
        jg = jar[:, start:start + k * dim].reshape(-1, k, dim)
        fri = d.contact.friction[:, list(conids), :dim - 1]
        mu = fri[..., 0] / torch.sqrt(m.opt.impratio)
        active = efc.D[:, start:start + k * dim:dim] > 0
        n = jg[..., 0]
        t = torch.linalg.vector_norm(fri * jg[..., 1:], dim=-1)
        bottom = (mu * mu * n + t <= 0) & active
        stick += int(bottom.sum())
        slide += int((active & ~bottom & (n < t)).sum())
    return stick, slide


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_states_reach_the_new_code(name):
    gold = golden(name)
    env = _env(*GOLDENS[name])
    state = start_state(env, gold, "contact")
    m = apply_model_diff(env.model, state.model_diff)
    d = env.task.before_step(m, env._unstrip(state.data), torch.as_tensor(
        gold["contact_actions"]))
    d = tengine.forward(m, d)
    efc = tcons.make_constraint(m, d)
    assert m.opt.cone == 1 and efc.ne == 1  # the fingers' tendon equality
    assert efc.kind[efc.nefc - efc.ncone - 1] == tcons.LIMIT
    assert set(efc.kind[efc.nefc - efc.ncone:]) == {tcons.CONE}
    stick, slide = _cone_zones(m, d, efc)
    assert stick > 0 and slide > 0
    assert state.model_diff["body_pos"].shape == (4, m.nbody, 3)
    S = GeomType
    if name == "manipulator":  # the ball in the hand
        assert float(d.sensordata.max()) > 0
        assert bool(_active(m, d, S.SPHERE, S.CAPSULE).any())
        assert state.model_diff["body_quat"].shape == (4, m.nbody, 4)
    if name == "manipulator_insert_peg":  # the peg against the slot
        assert bool(_active(m, d, S.CAPSULE, S.BOX).any())
        assert bool(_active(m, d, S.SPHERE, S.BOX).any())
    if name == "stacker":  # a box on a box, boxes flat on the floor
        assert bool(_active(m, d, S.BOX, S.BOX).any())
        assert int(_active(m, d, S.PLANE, S.BOX).sum()) >= 8
        # corners off the reference face: infinite distance, no force
        far = torch.isinf(d.contact.dist)
        assert bool(far.any())
        assert bool((d.contact_force[far] == 0).all())
        assert bool(torch.isfinite(d.qacc).all())


def _stacked(env, n):
    """stack_2 states (n, ...): the arm as in the stacker golden's later
    states (elsewhere its light finger links reach accelerations of 1e4
    to 1e5, where 1e-9 is below float64's resolution), box0 lying flat
    1 mm into the floor, box1 on it 1 mm deep, turned and shifted a
    little per state, the boxes moving a little, no control."""
    m = env.model
    names = m.names
    rng = np.random.default_rng(17)
    half = float(m.geom_size[names.geom["box0"], 2])
    qpos = m.qpos0.expand(n, m.nq).numpy().copy()
    gold = golden("stacker")
    arm = [m.jnt_qposadr[names.joint[j]] for j in ARM_JOINTS]
    qpos[:, arm] = gold["contact_qpos"][:n, arm]
    rest = tengine.fwd_position(m, make_data(m, 1)).xpos[0].numpy()

    def place(box, x, z, angle):
        at = rest[names.body[box]]
        for axis, delta in (("_x", x - at[0]), ("_z", z - at[2])):
            qpos[:, m.jnt_qposadr[names.joint[box + axis]]] += delta
        qpos[:, m.jnt_qposadr[names.joint[box + "_y"]]] = angle

    place("box0", 0.2, half - 1e-3, 0.0)
    place("box1", 0.2 + rng.uniform(-0.3, 0.3, n) * half, 3 * half - 2e-3,
          rng.uniform(-0.1, 0.1, n))
    qvel = rng.normal(size=(n, m.nv)) * 0.05
    dofs = [m.jnt_dofadr[names.joint[j]] for j in ARM_JOINTS]
    qvel[:, dofs] = gold["contact_qvel"][:n, dofs]
    return dict(qpos=qpos, qvel=qvel, ctrl=np.zeros((n, m.nu)))


@pytest.mark.parametrize("asset", ["manipulator_insert_peg", "stacker_2"])
def test_stages_match_jax(asset):
    if asset == "stacker_2":
        env = _env("stacker", "stack_2")
        state = _stacked(env, 3)
        diff = {"body_pos": np.broadcast_to(
            env.model.body_pos.numpy(), (3, env.model.nbody, 3)).copy()}
    else:
        state, diff = golden_rows(golden(asset), [("reset", 0)] + [
            ("contact", e) for e in range(4)])
    m, out = stages_both(asset, state, diff)
    assert_stages_close(out, skip=("step_qacc",))
    got, want = (np.asarray(x) for x in out["step_qacc"])
    scale = np.abs(want).max(-1)
    assert scale.max() > 1e4  # the finger links
    np.testing.assert_array_less(np.abs(got - want).max(-1), 1e-12 * scale)
    kinds = out["kind"][0]
    assert kinds[0] == tcons.EQUALITY and kinds[-1] == tcons.CONE
    dist = out["contact_dist"][0]
    if asset == "stacker_2":
        d = make_data(m, 3).replace(qpos=torch.as_tensor(state["qpos"]))
        d = tengine.fwd_position(m, d)
        assert bool(_active(m, d, GeomType.BOX, GeomType.BOX).any(-1).all())
        assert bool(_active(m, d, GeomType.PLANE, GeomType.BOX).any(-1).all())
        assert bool(torch.isinf(dist).any())  # box-box corners off the face
        pos = out["efc_pos"][0]
        assert bool(torch.isinf(pos).any())
    assert int(out["solver_niter"][0].max()) >= 2


@pytest.mark.parametrize("domain,task", [("finger", "turn_hard"),
                                         ("manipulator", "insert_peg"),
                                         ("stacker", "stack_2")])
def test_two_environments_with_their_own_overrides_equal_single_runs(
        domain, task):
    """Every override of the task's reset (dof_damping, site_pos and
    site_size; body_pos and body_quat; body_pos) carried per environment:
    two environments stepped together equal each stepped alone, and the
    two overrides differ."""
    env = _env(domain, task)
    state, _ = env.reset(2, torch.Generator().manual_seed(3))
    diff = state.model_diff
    assert all(v.shape[0] == 2 for v in diff.values())
    assert any(not torch.equal(v[0], v[1]) for v in diff.values())
    action = torch.as_tensor(np.random.default_rng(4).uniform(
        -1, 1, (2, env.model.nu)))
    both, ts = env.step(state, action)
    for i in range(2):
        rows = slice(i, i + 1)
        one = env.from_state(
            *(getattr(state.data, f)[rows] for f in ("qpos", "qvel",
                                                     "qacc_warmstart",
                                                     "time")),
            generator=torch.Generator().manual_seed(0),
            model_diff={k: v[rows] for k, v in diff.items()})
        alone, ts1 = env.step(one, action[rows])
        for f in ("qpos", "qvel", "qacc_warmstart"):
            torch.testing.assert_close(getattr(alone.data, f),
                                       getattr(both.data, f)[rows], rtol=0,
                                       atol=1e-12)
        for k, v in ts1.observation.items():
            torch.testing.assert_close(v, ts.observation[k][rows], rtol=0,
                                       atol=1e-12)


def test_stacker_target_height_is_an_odd_number_of_box_sizes():
    env = _env("stacker", "stack_4")
    m = env.model
    rc_state, _ = env.reset(64, torch.Generator().manual_seed(8))
    size = float(m.geom_size[m.names.geom["target"], 0])
    heights = rc_state.model_diff["body_pos"][:, m.names.body["target"], 2]
    levels = heights / size
    np.testing.assert_allclose(levels.numpy(), np.round(levels.numpy()),
                               atol=1e-12)
    assert set(np.round(levels.numpy()).astype(int)) == {1, 3, 5, 7}
    x = rc_state.model_diff["body_pos"][:, m.names.body["target"], 0]
    assert bool(((x >= -0.37) & (x < 0.37)).all())
    assert not math.isclose(float(x.std()), 0.0)


@pytest.mark.parametrize("domain,task", [
    t for t in tsuite.ALL_TASKS if t[0] in ("manipulator", "stacker")])
def test_task_functions_match_jax(domain, task):
    tasks.test_task_functions_match_jax(domain, task)


@pytest.mark.parametrize("asset", [
    a for d in ("manipulator", "stacker")
    for a in model_io_tests.export_tool().ASSETS[d]])
def test_checked_in_asset_equals_a_fresh_export(asset):
    model_io_tests.test_checked_in_asset_equals_a_fresh_export(asset)
