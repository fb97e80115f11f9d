"""The port's finger path against the JAX package, in float64 on the CPU:
friction loss and the elliptic cone in the Newton solver, the joint
sensors, and the per-episode ``dof_damping``, ``site_pos`` and
``site_size``.

Unit checks first: the rows' Huber cost in its quadratic and both linear
branches, and the elliptic cone's cost, gradient and Hessian blocks in
each of its three zones (and at a tangential force of exactly zero),
against the JAX package's ``_cost_terms`` and ``_cone_eval`` within 1e-12.
Then the pipeline from the finger golden's states
(tools/export_torch_assets.py, turn_hard): the stages within 1e-12, the
constraint rows (equal kinds in equal order) within 1e-10, one
``engine.step`` within 1e-9 with equal ``solver_niter``, one
``BatchEnv.step`` within 1e-8.  The three tasks against the JAX
package's tasks of the same names (observation, reward, termination after
the "acc" observe branch) within 1e-10, through tests/test_torch_tasks.py's
functions, with state 0 one the task's reward pays for.  Both sides
compute the same expressions and differ in the order of their sums.
The asset equals a fresh export, through tests/test_torch_model_io.py's
function, here where its JAX model is compiled anyway.  Marked ``slow``:
the golden file equals a fresh JAX run.
"""

import types

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
from dm_control_torch.physics import solver as tsolver
from dm_control_torch.physics.model import SensorType
from dm_control_torch.rl.control import apply_model_diff

ATOL = 1e-12


def _env(task="turn_hard"):
    return tsuite.load_batch("finger", task, device="cpu",
                             dtype=torch.float64, autoreset=False)


# -- the row costs ------------------------------------------------------------


#: D jar against the bound 0.1 of friction-loss rows: inside, above, below
FL_BRANCHES = {"quadratic": 0.05, "linear_above": 0.4, "linear_below": -0.7}


@pytest.mark.parametrize("branch", FL_BRANCHES)
def test_huber_cost_matches_jax(branch):
    """Rows in the order equality, friction loss, limit, cone; the
    friction-loss rows are pushed into ``branch``, the others meet both
    signs of jar."""
    import jax.numpy as jnp

    from dm_control_tpu.physics import solver as jsolver

    rng = np.random.default_rng(len(branch))
    B, ne, nf, nl, nc = 3, 2, 3, 4, 6
    n = ne + nf + nl + nc
    D = rng.uniform(0.5, 50.0, (B, n))
    jar = rng.normal(size=(B, n))
    fl = slice(ne, ne + nf)
    jar[:, fl] = FL_BRANCHES[branch] * rng.uniform(0.8, 1.2, (B, nf)) \
        / D[:, fl]
    floss = np.zeros(n)
    floss[fl] = 0.1
    kind = [0] * ne + [1] * nf + [2] * nl + [3] * nc
    efc = types.SimpleNamespace(kind=tuple(kind), nefc=n, ne=ne, nf=nf,
                                ncone=nc)
    masks = tsolver._row_masks(types.SimpleNamespace(
        cached=lambda key, build: build(), device="cpu"), efc)
    Dt = torch.as_tensor(D)
    got = tsolver._cost_terms(Dt, torch.as_tensor(jar), masks, (
        torch.as_tensor(floss), 0.5 * torch.as_tensor(floss) ** 2
        / torch.clamp(Dt, min=1e-15)))
    eq, flm, uni = (jnp.asarray(np.array(kind) == k) for k in (0, 1, 2))
    for b in range(B):
        want = jsolver._cost_terms(
            types.SimpleNamespace(D=jnp.asarray(D[b]),
                                  floss=jnp.asarray(floss)),
            jnp.asarray(jar[b]), eq, flm, uni)
        for g, w, what in zip(got, want, ("cost", "grad", "hess")):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL, err_msg=what)
    cost = got[0].numpy()
    assert (cost[:, ne + nf + nl:] == 0).all()  # cone rows: not here
    if branch != "quadratic":  # linear: the gradient is +-floss
        np.testing.assert_array_equal(np.abs(got[1].numpy()[:, fl]), 0.1)
        assert (got[2].numpy()[:, fl] == 0).all()


#: per zone: (n, tangential scale) of a contact's rows, friction 1 and 0.005
CONE_ZONES = {"separating": (1.0, 0.02), "sticking": (-1.0, 0.02),
              "sliding": (-0.05, 3.0), "tangent_zero_sticking": (-0.5, 0.0),
              "tangent_zero_separating": (0.5, 0.0), "no_force": (-1.0, 1.0)}


@pytest.mark.parametrize("dim", [3, 6])
@pytest.mark.parametrize("zone", CONE_ZONES)
def test_cone_eval_matches_jax(zone, dim):
    import jax.numpy as jnp

    from dm_control_tpu.physics import solver as jsolver

    rng = np.random.default_rng(dim)
    B, k, start = 2, 3, 2
    n, scale = CONE_ZONES[zone]
    fri = rng.uniform(0.5, 1.5, (B, k, 1)) * np.array(
        [1.0, 1.0, 0.005, 1e-4, 1e-4][:dim - 1])
    impratio = 1.0
    mu = fri[..., 0] / np.sqrt(impratio)
    D0 = rng.uniform(10.0, 100.0, (B, k))
    if zone == "no_force":
        D0[:] = 0.0
    Dg = np.concatenate([D0[..., None], D0[..., None] * impratio
                         * (fri / fri[..., :1]) ** 2], -1)
    jar_g = np.concatenate([n * rng.uniform(0.8, 1.2, (B, k, 1)),
                            scale * rng.normal(size=(B, k, dim - 1))
                            / fri], -1)
    jar = np.concatenate([rng.normal(size=(B, start)),
                          jar_g.reshape(B, -1)], -1)
    jp = rng.normal(size=jar.shape)
    groups = [(start, k, dim, torch.as_tensor(fri), torch.as_tensor(mu),
               torch.as_tensor(Dg))]
    cost, dcone, (hess,), _ = tsolver._cone_eval(groups, torch.as_tensor(
        jar), hess=True)
    _, _, _, curv = tsolver._cone_eval(groups, torch.as_tensor(jar),
                                       jp=torch.as_tensor(jp))
    for b in range(B):
        jgroups = [((start, k, dim), jnp.asarray(fri[b]), jnp.asarray(mu[b]),
                    jnp.asarray(Dg[b]))]
        jcost, ((jstart, jd),), (jh,) = jsolver._cone_eval(
            jgroups, jnp.asarray(jar[b]), need_hess=True)
        assert jstart == start
        np.testing.assert_allclose(float(cost[b]), float(jcost), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(dcone[b].numpy(), np.asarray(jd), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(hess[b].numpy(), np.asarray(jh), rtol=0,
                                   atol=ATOL)
        jp_g = jp[b, start:].reshape(k, dim)
        np.testing.assert_allclose(
            float(curv[b]), np.einsum("ki,kij,kj->", jp_g, np.asarray(jh),
                                      jp_g), rtol=1e-12, atol=ATOL)
    h = hess.numpy()
    if zone in ("separating", "tangent_zero_separating", "no_force"):
        assert (h == 0).all() and float(cost.abs().max()) == 0
    elif zone.endswith("sticking"):  # each row on its own: diagonal
        assert (h == np.eye(dim) * h).all() and (h.diagonal(0, -2, -1)
                                                 > 0).all()
    else:  # sliding: the tangent block couples the rows
        assert (np.abs(h[..., 0, 1:]) > 0).all()


# -- the pipeline -------------------------------------------------------------


@pytest.mark.parametrize("prefix", PREFIXES)
def test_batch_env_step_matches_golden(prefix):
    assert_step_matches_golden(_env(), golden("finger"), prefix)


@pytest.mark.slow
def test_golden_file_equals_what_jax_gives_now():
    gold = golden("finger")
    fresh = export_tool().make_golden("finger")
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_golden_states_reach_the_new_code():
    """At the later states the spinner touches the finger (touch > 0,
    through an elliptic cone), and the hinge's friction-loss row is in a
    linear branch of its Huber cost in some environment."""
    from dm_control_torch.physics import engine as tengine
    from dm_control_torch.rl.golden import start_state

    gold = golden("finger")
    env = _env()
    state = start_state(env, gold, "contact")
    m = apply_model_diff(env.model, state.model_diff)
    d = env.task.before_step(m, env._unstrip(state.data), torch.as_tensor(
        gold["contact_actions"]))
    d = tengine.forward(m, d)
    efc = tcons.make_constraint(m, d)
    assert m.opt.cone == 1 and efc.nf == 1 and efc.ne == 0
    assert efc.kind[0] == tcons.FRICTIONLOSS
    assert efc.kind[-1] == tcons.CONE and efc.ncone == 3 * len(d.contact.dim)
    jar = torch.einsum("bkv,bv->bk", efc.J, d.qacc) - efc.aref
    assert bool(((efc.D[:, 0] * jar[:, 0]).abs() > efc.floss[0]).any())
    touch = torch.cat([env.task.sensordata(m, d, s)
                       for s in ("touchtop", "touchbottom")], -1)
    assert float(touch.max()) > 0
    # the joint sensors read the joints
    for s in range(m.nsensor):
        j = m.sensor_objid[s]
        if m.sensor_type[s] == int(SensorType.JOINTPOS):
            assert torch.equal(d.sensordata[:, m.sensor_adr[s]],
                               d.qpos[:, m.jnt_qposadr[j]])
        if m.sensor_type[s] == int(SensorType.JOINTVEL):
            assert torch.equal(d.sensordata[:, m.sensor_adr[s]],
                               d.qvel[:, m.jnt_dofadr[j]])
    # the damping diff reached the implicit Euler step: one environment
    # alone without it steps elsewhere
    assert state.model_diff["dof_damping"].shape == (4, m.nv)


def test_stages_match_jax():
    gold = golden("finger")
    state, diff = golden_rows(gold, [("reset", 0)] + [("contact", e)
                                                      for e in range(4)])
    _, out = stages_both("finger", state, diff)
    assert_stages_close(out)
    kinds = out["kind"][0]
    assert kinds[0] == tcons.FRICTIONLOSS and kinds[-1] == tcons.CONE
    assert int(out["solver_niter"][0].max()) >= 2


@pytest.mark.parametrize("task", ["spin", "turn_easy", "turn_hard"])
def test_task_functions_match_jax(task):
    tasks.test_task_functions_match_jax("finger", task)


def test_checked_in_asset_equals_a_fresh_export():
    model_io_tests.test_checked_in_asset_equals_a_fresh_export("finger")
