"""The port's quadruped paths against the JAX package, in float64 on the
CPU, from the three quadruped goldens (tools/export_torch_assets.py: walk,
escape with its per-episode terrain, fetch with the ball at rest on the
floor).

Function by function the tolerance is 1e-12 (contacts of the cylinder,
ellipsoid and heightfield colliders, activation dynamics, position- and
velocity-stage sensors, the rangefinder), 1e-10 for the constraint rows in
the JAX package's order, 1e-9 for one ``engine.step`` with equal
``solver_niter``, 1e-8 for one ``BatchEnv.step`` (four substeps).  Both
sides compute the same expressions and differ in the order of their sums.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import PREFIXES, assert_stages_close, \
    assert_step_matches_golden, export_tool, golden, golden_rows, \
    golden_state, jax_model_from_asset, stages_both
from dm_control_torch import suite as tsuite
from dm_control_torch.physics import actuation as tact
from dm_control_torch.physics import constraints as tcons
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import sensors as tsens
from dm_control_torch.physics.model import GeomType, SensorType, make_data
from dm_control_torch.rl.control import RandomContext

#: golden -> (asset, task)
GOLDENS = {"quadruped": ("quadruped_walk", "walk"),
           "quadruped_escape": ("quadruped_escape", "escape"),
           "quadruped_fetch": ("quadruped_fetch", "fetch")}


def _env(task):
    return tsuite.load_batch("quadruped", task, device="cpu",
                             dtype=torch.float64, autoreset=False)


def _forwarded(name, prefix="contact"):
    """(env, model with the golden's overrides, Data after ``forward``) at
    the golden's ``prefix`` states."""
    from dm_control_torch.rl.control import apply_model_diff

    env = _env(GOLDENS[name][1])
    state = golden_state(env, golden(name), prefix)
    m = apply_model_diff(env.model, state.model_diff)
    return env, m, tengine.forward(m, env._unstrip(state.data))


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("name", GOLDENS)
def test_batch_env_step_matches_golden(name, prefix):
    assert_step_matches_golden(_env(GOLDENS[name][1]), golden(name), prefix)


def _touching(m, d, first, second):
    """(B, K) dist of the contacts between a geom named in ``first`` and
    one named in ``second``."""
    g1 = {m.names.geom[n] for n in first}
    g2 = {m.names.geom[n] for n in second}
    cols = [c for c, pair in enumerate(zip(d.contact.geom1, d.contact.geom2))
            if pair[0] in g1 and pair[1] in g2]
    assert cols
    return d.contact.dist[:, cols], cols


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_states_reach_the_new_code(name):
    gold = golden(name)
    env, m, d = _forwarded(name)
    efc = tcons.make_constraint(m, d)
    # activations are under way, and the four tendon equality rows (the
    # first rows) are off their targets
    assert float(np.abs(gold["contact_act"]).max()) > 0.1
    assert efc.ne == 4 and efc.kind[:5] == (0, 0, 0, 0, 2)
    assert bool((efc.pos[:, :4].abs() > 1e-6).any())
    assert bool((efc.D[:, :4] > 0).all())
    torso_and_toes = ["torso"] + [f"toe_{a}_{b}" for a in ("front", "back")
                                  for b in ("left", "right")]
    if name == "quadruped":
        # every environment lies on the floor, two of them on the torso
        # (the plane-ellipsoid collider)
        assert bool((d.contact.dist < 0).any(-1).all())
        dist, _ = _touching(m, d, ["floor"], ["torso"])
        assert int((dist < 0).any(-1).sum()) >= 2
    if name == "quadruped_escape":
        dist, cols = _touching(m, d, ["terrain"], torso_and_toes + [
            n for n in m.names.geom if n.startswith(("shin", "foot",
                                                     "thigh"))])
        assert m.geom_type[m.names.geom["terrain"]] == int(GeomType.HFIELD)
        assert bool((dist < 0).any(-1).all())
        assert bool((d.contact_force[:, cols] > 0).any())
        terrain = torch.as_tensor(gold["contact_diff_hfield_data"])
        assert terrain.shape == (4, 201, 201)
        assert not torch.equal(terrain[0], terrain[1])
    if name == "quadruped_fetch":
        dist, cols = _touching(m, d, ["floor"], ["ball"])
        resting = dist[:, 0] < 0
        assert int(resting.sum()) >= 3
        assert d.contact.dim[cols[0]] == 6
        (ids, start, nrows), = [s for s in efc.contact_spans
                                if cols[0] in s[0]]
        assert nrows == 10  # 2 * (condim - 1)
        at = start + nrows * ids.index(cols[0])
        assert bool((efc.D[resting, at:at + nrows] > 0).all())
        assert bool((d.contact_force_vec[resting, cols[0], 0] > 0).all())
        assert sorted(set(d.contact.dim)) == [1, 3, 6]


#: the states ``stages_both`` runs: one in the air after the reset, the
#: others on the ground
PICKS = [("reset", 0), ("contact", 0), ("contact", 1), ("contact", 2)]


@pytest.mark.parametrize("name", GOLDENS)
def test_stages_match_jax(name):
    state, diff = golden_rows(golden(name), PICKS)
    m, out = stages_both(GOLDENS[name][0], state, diff)
    assert_stages_close(out)
    nefc = out["efc_J"][0].shape[1]
    assert nefc == out["efc_J"][1].shape[1] == len(out["kind"][0])
    # equality rows first, then limits and contacts
    assert out["kind"][0][:4] == (0,) * 4 and set(out["kind"][0][4:]) == {2}
    # on the ground the solver iterates, contacts carry force, and the
    # force and torque sensors read it
    assert int(out["solver_niter"][0][1:].min()) >= 1
    assert float(out["step_contact_force_vec"][0][1:].abs().max()) > 1.0
    ft = [m.sensor_adr[s] for s in range(m.nsensor) if m.sensor_type[s]
          in (int(SensorType.FORCE), int(SensorType.TORQUE))]
    assert float(out["step_sensordata"][0][1:, ft].abs().max()) > 1.0
    assert float(out["act_dot"][0].abs().max()) > 0.1


def test_activation_dynamics_match_jax():
    """INTEGRATOR, FILTER, FILTEREXACT and no dynamics side by side, on
    quadruped's actuators with drawn lengths, velocities and moments."""
    import jax.numpy as jnp

    from dm_control_tpu.physics import actuation as jact
    from dm_control_tpu.physics.model import make_data as jmake_data

    jm = jax_model_from_asset("quadruped_walk")
    tm = _env("walk").model
    dyn = (1, 2, 3, 0) * 3
    actadr = tuple(int(np.cumsum([t != 0 for t in dyn])[u]) - 1
                   if dyn[u] else -1 for u in range(12))
    na = sum(t != 0 for t in dyn)
    over = dict(actuator_dyntype=dyn, actuator_actadr=actadr, na=na)
    rng = np.random.default_rng(2)
    B = 3
    draw = dict(ctrl=rng.uniform(-1.5, 1.5, (B, 12)),
                act=rng.uniform(-1, 1, (B, na)),
                actuator_length=rng.normal(size=(B, 12)),
                actuator_velocity=rng.normal(size=(B, 12)),
                actuator_moment=1e-3 * rng.normal(size=(B, 12, tm.nv)))
    tmm = tm.replace(**over)
    td = tact.fwd_actuation(tmm, make_data(tmm, B).replace(
        **{k: torch.as_tensor(v) for k, v in draw.items()}))
    jmm = jm.replace(**over)
    for b in range(B):
        jd = jact.fwd_actuation(jmm, jmake_data(jmm).replace(
            **{k: jnp.asarray(v[b]) for k, v in draw.items()}))
        for f in ("act_dot", "actuator_force", "qfrc_actuator"):
            np.testing.assert_allclose(getattr(td, f)[b].numpy(),
                                       np.asarray(getattr(jd, f)), rtol=0,
                                       atol=1e-12, err_msg=f)
    assert td.act_dot.shape == (B, na)
    # an integrator's rate is its (clamped) control
    lo, hi = tm.actuator_ctrlrange[0]
    torch.testing.assert_close(td.act_dot[:, 0], torch.as_tensor(
        draw["ctrl"][:, 0]).clamp(lo, hi))


def test_rangefinder_matches_jax():
    """All twenty rays of escape against the floor and the toes' spheres,
    at the golden states and at states lifted and turned so that some rays
    miss (-1) and some hit a sphere."""
    import jax.numpy as jnp

    from dm_control_tpu.physics import sensors as jsens
    from dm_control_tpu.physics.model import make_data as jmake_data

    jm = jax_model_from_asset("quadruped_escape")
    env, m, d = _forwarded("quadruped_escape")
    sensors = [s for s in range(m.nsensor)
               if m.sensor_type[s] == int(SensorType.RANGEFINDER)]
    assert len(sensors) == 20
    got = tsens._rangefinder(m, d, sensors)
    assert got.shape == (4, 20)
    for b in range(4):
        jd = jmake_data(jm).replace(
            site_xpos=jnp.asarray(d.site_xpos[b].numpy()),
            site_xmat=jnp.asarray(d.site_xmat[b].numpy()),
            geom_xpos=jnp.asarray(d.geom_xpos[b].numpy()),
            geom_xmat=jnp.asarray(d.geom_xmat[b].numpy()))
        want = [float(jsens._rangefinder(jm, jd, m.sensor_objid[s]))
                for s in sensors]
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-12)
    assert bool((got == -1).any()) and bool((got > 0).any())
    # the same numbers reach sensordata at the sensors' addresses
    cols = [m.sensor_adr[s] for s in sensors]
    torch.testing.assert_close(d.sensordata[:, cols], got, rtol=0, atol=0)


def test_drop_to_ground_equals_single_environment_runs():
    env = _env("walk")
    m, task = env.model, env.task
    rc = RandomContext(torch.Generator().manual_seed(4), 3, torch.float64)
    orientation = torch.nn.functional.normalize(rc.randn(4), dim=-1)
    qpos0 = m.qpos0.expand(3, m.nq)
    both = task._drop_to_ground(m, qpos0, orientation, {})
    heights = both[:, 2]
    assert len(set(heights.tolist())) == 3  # each stopped at its own height
    assert task.last_drop_rounds == round(float(heights.max()) / 0.01)
    for i in range(3):
        alone = task._drop_to_ground(m, qpos0[i:i + 1],
                                     orientation[i:i + 1], {})
        torch.testing.assert_close(alone, both[i:i + 1], rtol=0, atol=0)
    # nothing penetrates, and one step lower something did
    d = tengine.fwd_position(m, make_data(m, 3).replace(qpos=both))
    assert bool((d.contact.dist >= 0).all())
    lower = both.clone()
    lower[:, 2] -= 0.01
    d = tengine.fwd_position(m, make_data(m, 3).replace(qpos=lower))
    assert bool((d.contact.dist < 0).any(-1).all())


def test_escape_draws_a_terrain_per_environment_and_stands_on_it():
    env = _env("escape")
    state, ts = env.reset(3, torch.Generator().manual_seed(6))
    terrain = state.model_diff["hfield_data"]
    assert terrain.shape == (3, 201, 201)
    assert not torch.equal(terrain[0], terrain[1])
    assert float(terrain.min()) >= -0.1 and float(terrain.max()) <= 1.1
    assert float(terrain[:, 100, 100].abs().max()) < 0.02  # the bowl's centre
    assert 1 <= env.task.last_drop_rounds < 1000
    assert ts.observation["rangefinder"].shape == (3, 20)
    assert all(bool(torch.isfinite(v).all())
               for v in ts.observation.values())


@pytest.mark.slow
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_file_equals_what_jax_gives_now(name):
    gold = golden(name)
    fresh = export_tool().make_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_activations_start_at_zero_and_are_carried():
    env = tsuite.load_batch("quadruped", "walk", device="cpu",
                            dtype=torch.float64)
    assert "act" in env._state_fields and env.model.na == 12
    state, _ = env.reset(2, torch.Generator().manual_seed(1))
    assert torch.equal(state.data.act, torch.zeros(2, 12,
                                                   dtype=torch.float64))
    action = torch.full((2, 12), 0.5, dtype=torch.float64)
    state, ts = env.step(state, action)
    act = state.data.act.clone()
    assert bool((act > 0).all())  # the filters follow the control
    # the observation ends with the carried activations
    torch.testing.assert_close(ts.observation["egocentric_state"][:, -12:],
                               act, rtol=0, atol=0)
    # an autoreset zeroes the finished environment's activations only
    state = state.replace(needs_reset=torch.tensor([True, False]))
    state, _ = env.step(state, action)
    assert bool((state.data.act[0] == 0).all())
    assert bool((state.data.act[1] > act[1]).all())
