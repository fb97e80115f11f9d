"""The port's tendon code against the JAX package's, function by function,
in float64 within 1e-12: lengths and moments of fixed (point_mass) and
spatial (ball_in_cup) tendons, the tendon passive force, the tendon limit
rows, and the TENDON transmission.  States are numpy draws around the
models' rest poses; point_mass runs with a different ``wrap_prm`` in each
environment, as its ``hard`` task does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_model
from dm_control_tpu.physics import constraints as jcons
from dm_control_tpu.physics import engine as jengine
from dm_control_tpu.physics.model import make_data as jmake_data
from dm_control_torch.physics import constraints as tcons
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics.model import make_data
from dm_control_torch.suite import base as tbase

B = 3
ATOL = 1e-12


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL,
                               err_msg=what)


def _setup(domain, overrides=None, static=None):
    """Both models (with the same overrides; ``static`` holds those that
    are Python values), and both packages' Data after the position and
    velocity stages at B drawn states."""
    rng = np.random.default_rng(17)
    jm = jax_model(domain)
    m = tbase.load_model(domain, "cpu", torch.float64)
    overrides = dict(overrides or {})
    static = dict(static or {})
    jm = jm.replace(**static)
    m = m.replace(**static)
    qpos = np.asarray(jm.qpos0) + rng.uniform(-0.2, 0.2, (B, jm.nq))
    if domain == "ball_in_cup":
        # ball 0.32 below the cup in environment 0: the string (limit 0.3)
        # is taut there and slack in the others
        qpos[0] = np.asarray(jm.qpos0) + np.array([0.05, 0.02, 0.06, -0.32])
    qvel = rng.uniform(-1.0, 1.0, (B, jm.nv))
    batched = {}
    if domain == "point_mass":
        batched["wrap_prm"] = rng.uniform(-1.0, 1.0, (B, jm.nwrap))

    def jforward(q, v, diff):
        mm = jm.replace(**{k: jnp.asarray(x) for k, x in overrides.items()},
                        **diff)
        d = jmake_data(mm).replace(qpos=q, qvel=v)
        d = jengine.fwd_velocity(mm, jengine.fwd_position(mm, d))
        efc = jcons.make_constraint(mm, d)
        return d, (efc.J, efc.D, efc.R, efc.aref, efc.pos)

    jd, jefc = jax.vmap(jforward)(
        jnp.asarray(qpos), jnp.asarray(qvel),
        {k: jnp.asarray(x) for k, x in batched.items()})
    tm = m.replace(**{k: torch.as_tensor(x)
                      for k, x in {**overrides, **batched}.items()})
    td = make_data(tm, B).replace(qpos=torch.as_tensor(qpos),
                                  qvel=torch.as_tensor(qvel))
    td = tengine.fwd_velocity(tm, tengine.fwd_position(tm, td))
    return tm, td, jd, jefc


@pytest.mark.parametrize("domain", ["point_mass", "ball_in_cup"])
def test_tendon_length_moment_and_velocity(domain):
    m, td, jd, _ = _setup(domain)
    assert td.ten_length.shape == (B, m.ntendon)
    _close(td.ten_length, jd.ten_length, "ten_length")
    _close(td.ten_moment, jd.ten_moment, "ten_moment")
    _close(td.ten_velocity, jd.ten_velocity, "ten_velocity")
    assert float(td.ten_moment.abs().max()) > 0.1


@pytest.mark.parametrize("domain", ["point_mass", "ball_in_cup"])
def test_tendon_passive_force(domain):
    nt = jax_model(domain).ntendon
    length0 = np.asarray(jax_model(domain).tendon_length0)
    # a deadband around the rest length narrow enough that some drawn
    # states fall on each side of it, and a damper
    spring = np.stack([length0 - 0.02, length0 + 0.02], -1)
    m, td, jd, _ = _setup(domain, dict(
        tendon_stiffness=np.full(nt, 30.0), tendon_damping=np.full(nt, 2.0),
        tendon_lengthspring=spring))
    _close(td.qfrc_passive, jd.qfrc_passive, "qfrc_passive")
    without = _setup(domain)[1].qfrc_passive
    assert float((td.qfrc_passive - without).abs().max()) > 0.1


def test_tendon_limit_rows():
    m, td, _, jefc = _setup("ball_in_cup")
    efc = tcons.make_constraint(m, td)
    for name, j in zip(("J", "D", "R", "aref", "pos"), jefc):
        _close(getattr(efc, name), j, name)
    # rows 0 and 1 are the string's lower and upper limit; the upper one
    # is active where the string is taut, and only there
    assert efc.D[:, 1].gt(0).tolist() == [True, False, False]
    assert efc.D[:, 0].gt(0).tolist() == [False, False, False]
    _close(efc.J[:, 1], -np.asarray(td.ten_moment[:, 0]), "J of the limit")


def test_joint_and_tendon_equality_rows():
    """Three equalities on point_mass in one model, in this order: a JOINT
    quartic between the two slides, a TENDON quartic between the two
    tendons, a JOINT row with no second joint.  The rows come first, in
    the model's order, and are always active."""
    rng = np.random.default_rng(5)
    eq_data = np.zeros((3, 11))
    eq_data[:, :5] = rng.uniform(-0.5, 0.5, (3, 5))
    m, td, _, jefc = _setup("point_mass", dict(
        eq_data=eq_data, eq_solref=np.tile([0.02, 1.0], (3, 1)),
        eq_solimp=np.tile([0.9, 0.95, 0.001, 0.5, 2.0], (3, 1))), dict(
        neq=3, eq_type=(2, 3, 2), eq_obj1id=(0, 1, 1), eq_obj2id=(1, 0, -1),
        eq_active0=(1, 1, 1)))
    efc = tcons.make_constraint(m, td)
    assert efc.ne == 3 and efc.kind[:4] == (0, 0, 0, 2)
    for name, j in zip(("J", "D", "R", "aref", "pos"), jefc):
        _close(getattr(efc, name), j, name)
    assert bool((efc.D[:, :3] > 0).all())
    # the last row ties joint 1 alone: one entry in its Jacobian
    assert efc.J[:, 2].ne(0).sum(-1).tolist() == [1] * B
    assert efc.J[:, 1].ne(0).sum(-1).tolist() == [2] * B


def test_tendon_transmission():
    m, td, jd, _ = _setup("point_mass")
    assert all(t == 3 for t in m.actuator_trntype)  # TrnType.TENDON
    _close(td.actuator_length, jd.actuator_length, "actuator_length")
    _close(td.actuator_moment, jd.actuator_moment, "actuator_moment")
    _close(td.actuator_velocity, jd.actuator_velocity, "actuator_velocity")
    # each environment's moment carries its own coupling
    assert not torch.equal(td.actuator_moment[0], td.actuator_moment[1])


def test_other_tendon_features_still_raise():
    from dm_control_torch.physics import kinematics as tkin
    from dm_control_torch.physics import sensors as tsens

    m = tbase.load_model("ball_in_cup", "cpu", torch.float64)
    wrapped = m.replace(wrap_type=(3, 4))  # a site, then a sphere to wrap
    with pytest.raises(NotImplementedError, match="wrapping"):
        tkin.tendon(wrapped, make_data(wrapped, 1))
    # a TENDONPOS sensor, which used to raise, reads the tendon's length
    sensing = m.replace(nsensor=1, sensor_type=(10,), sensor_objtype=(0,),
                        sensor_objid=(0,), sensor_adr=(0,), sensor_dim=(1,),
                        nsensordata=1)
    d = tkin.tendon(sensing, tkin.com_pos(sensing, tkin.kinematics(
        sensing, make_data(sensing, 1))))
    torch.testing.assert_close(tsens.sensor_pos(sensing, d).sensordata[:, 0],
                               d.ten_length[:, 0], rtol=0, atol=0)
    tied = m.replace(neq=1, eq_type=(4,))  # EqType.DISTANCE
    with pytest.raises(NotImplementedError, match="DISTANCE equality"):
        tcons.make_constraint(tied, make_data(tied, 1))
