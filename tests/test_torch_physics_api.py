"""The port's ``Physics`` facade, named indexing, ``jac``/``jac_site`` and
inverse kinematics against the JAX package's, in float64 on the CPU.

Both sides hold the same state: the JAX ``Physics`` is handed the Data
the port's ``forward`` computed, so nothing of the JAX package is
jit-compiled here.  Named reads and writes (free-joint rows of qpos and
of dofs, sensor rows, named columns of frames, lists of names) agree
exactly; the Jacobians of bodies and sites within 1e-12;
``qpos_from_site_pose`` within 1e-10 on manipulator's arm, to a
position and an orientation of its grasp site.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import jax_model_from_asset
from dm_control_torch.physics import kinematics as tkin
from dm_control_torch.physics.physics import Physics, PhysicsError
from dm_control_torch.suite import base as tbase


def _both(asset, seed=0):
    """(port Physics, JAX Physics) of ``asset`` at one state: qpos0 moved
    by a seeded draw (quaternions normalized), velocities and controls
    drawn, after the port's ``forward``."""
    import jax.numpy as jnp

    from dm_control_tpu.physics import physics as jphysics
    from dm_control_tpu.physics.model import make_data as jmake_data

    tm = tbase.load_model(asset, "cpu", torch.float64)
    rng = np.random.RandomState(seed)
    p = Physics(tm)
    q = tm.qpos0.numpy() + 0.1 * rng.randn(tm.nq)
    for j in range(tm.njnt):
        if tm.jnt_type[j] == 0:  # free: keep the quaternion unit
            a = tm.jnt_qposadr[j] + 3
            q[a:a + 4] /= np.linalg.norm(q[a:a + 4])
    p.set_state(np.concatenate([q, rng.randn(tm.nv), np.zeros(tm.na)]))
    p.set_control(rng.uniform(-1, 1, tm.nu))
    p.forward()
    jm = jax_model_from_asset(asset)
    jd = jmake_data(jm)
    port = p.data
    jd = jd.replace(**{f.name: jnp.asarray(getattr(port, f.name).numpy())
                       for f in dataclasses.fields(jd)
                       if f.name != "contact"
                       and isinstance(getattr(port, f.name, None),
                                      torch.Tensor)
                       and getattr(port, f.name).shape
                       == getattr(jd, f.name).shape})
    return p, jphysics.Physics(jm, jd)


def _same(t, j, what):
    """Equal reads: an array, or a list of the rows of unequal widths."""
    if isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), what
    else:
        t, j = [t], [j]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def test_named_reads_match_jax():
    p, jp = _both("humanoid")
    cases = [("qpos", "root"), ("qpos", "abdomen_z"), ("qvel", "root"),
             ("qvel", ["root", "abdomen_z"]),
             ("qfrc_bias", "right_knee"), ("xpos", "torso"),
             ("xpos", ("torso", "z")), ("xmat", ("torso", "zz")),
             ("xmat", ("torso", ["xx", "zz"])),
             ("xmat", ["torso", "head"]), ("xquat", ("head", "qw")),
             ("geom_xpos", "head"), ("site_xpos", ["left_hand", "right_hand"]),
             ("sensordata", "torso_subtreelinvel"),
             ("sensordata", ["torso_subtreelinvel", "torso_gyro"]),
             ("ctrl", "abdomen_y"), ("subtree_com", ("torso", "x"))]
    for field, key in cases:
        _same(getattr(p.named.data, field)[key],
              getattr(jp.named.data, field)[key], f"{field}[{key}]")
    for field, key in [("body_mass", "torso"), ("geom_size", ("head", "x")),
                       ("dof_damping", "root"), ("jnt_range", "right_knee"),
                       ("geom_rgba", ("floor", ["r", "a"]))]:
        np.testing.assert_array_equal(
            getattr(p.named.model, field)[key],
            np.asarray(getattr(jp.named.model, field)[key]), err_msg=field)
    for kind, names in [("qpos", "root"), ("qvel", ["root", "abdomen_z"]),
                        ("sensordata", "torso_subtreelinvel"),
                        ("xpos", ["torso", "head"])]:
        _same(p.named_field(kind, names), jp.named_field(kind, names),
              f"named_field({kind}, {names})")
    assert p.named.data.xmat.axes == jp.named.data.xmat.axes


def test_named_writes_match_jax():
    p, jp = _both("humanoid", seed=1)
    writes = [("qpos", "root", np.array([0.1, 0.2, 1.3, 1, 0, 0, 0.])),
              ("qpos", "abdomen_z", 0.25), ("qvel", "root", np.arange(6.)),
              ("qpos", ["right_knee", "left_knee"], [-0.5, -0.6]),
              ("xfrc_applied", "torso", np.arange(6.) + 1),
              ("ctrl", "abdomen_y", 0.5)]
    for field, key, value in writes:
        getattr(p.named.data, field)[key] = value
        getattr(jp.named.data, field)[key] = value
        assert p.is_dirty and jp.is_dirty
        np.testing.assert_array_equal(
            getattr(p.data, field).numpy(),
            np.asarray(getattr(jp.data, field)), err_msg=f"{field}[{key}]")
    p.named.model.geom_rgba["floor", "a"] = 0.5
    jp.named.model.geom_rgba["floor", "a"] = 0.5
    np.testing.assert_array_equal(p.model.geom_rgba.numpy(),
                                  np.asarray(jp.model.geom_rgba))


def test_state_and_pose_match_jax():
    p, jp = _both("humanoid", seed=2)
    np.testing.assert_array_equal(p.get_state(), jp.get_state())
    state = p.get_state() * 0.5
    p.set_state(state)
    jp.set_state(state)
    np.testing.assert_array_equal(p.get_state(), np.asarray(jp.get_state()))
    p.set_body_pose("torso", [0.3, -0.2, 1.1], [0.0, 1.0, 0.0, 0.0])
    jp.set_body_pose("torso", [0.3, -0.2, 1.1], [0.0, 1.0, 0.0, 0.0])
    p.set_body_velocity("torso", [1.0, 2.0, 3.0], 0.5)
    jp.set_body_velocity("torso", [1.0, 2.0, 3.0], 0.5)
    np.testing.assert_array_equal(p.position(), np.asarray(jp.data.qpos))
    np.testing.assert_array_equal(p.velocity(), np.asarray(jp.data.qvel))
    assert p.is_dirty
    pos, quat = p.body_pose("torso")  # forwards first
    assert not p.is_dirty
    np.testing.assert_allclose(pos, [0.3, -0.2, 1.1], atol=1e-15)
    np.testing.assert_allclose(np.abs(quat), [0, 1, 0, 0], atol=1e-15)
    with pytest.raises(ValueError, match="no free joint"):
        p.set_body_pose("head", [0, 0, 1])
    copied = p.copy()
    copied.named.data.qpos["abdomen_z"] = 1.0
    assert p.named.data.qpos["abdomen_z"] != 1.0
    assert p.bind_id("head") == jp.bind_id("head")


def test_step_reset_and_divergence():
    p = Physics(tbase.load_model("pendulum", "cpu", torch.float64))
    with p.reset_context():
        p.named.data.qpos["hinge"] = 1.0
    assert not p.is_dirty
    p.step(3)
    assert p.time() == pytest.approx(3 * float(p.model.opt.timestep))
    p.reset()
    assert p.time() == 0.0 and p.named.data.qpos["hinge"] == 0.0
    p.set_state(np.array([0.0, 1e12]))
    with pytest.raises(PhysicsError):
        p.step()
    with pytest.raises(ValueError, match="worldbody"):
        Physics.from_xml_string("<mujoco/>", device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        p.render()


@pytest.mark.parametrize("asset", ["humanoid", "reacher_easy"])
def test_jac_matches_jax(asset):
    from dm_control_tpu.physics import kinematics as jkin

    p, jp = _both(asset, seed=3)
    m, jm = p.model, jp.model
    d = p._data
    for b in range(m.nbody):
        point = d.xipos[:, b] + 0.05
        tp, tr = tkin.jac(m, d, point, b)
        jjp, jjr = jkin.jac(jm, jp.data, point[0].numpy(), b)
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jjp), rtol=0,
                                   atol=1e-12, err_msg=f"jacp body {b}")
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jjr), rtol=0,
                                   atol=1e-12, err_msg=f"jacr body {b}")
    for s in range(m.nsite):
        tp, tr = tkin.jac_site(m, d, s)
        jjp, jjr = jkin.jac_site(jm, jp.data, s)
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jjp), rtol=0,
                                   atol=1e-12, err_msg=f"site {s}")
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jjr), rtol=0,
                                   atol=1e-12, err_msg=f"site {s}")


def test_qpos_from_site_pose_matches_jax():
    """A pose that the arm reaches (the grasp site's position and
    orientation at another configuration), with as many joints as the
    planar problem has degrees of freedom, so that each step's
    least-squares system has full rank."""
    from dm_control_tpu.utils import inverse_kinematics as jik
    from dm_control_torch.physics.model import make_data
    from dm_control_torch.utils import inverse_kinematics as tik
    from dm_control_torch.utils import transformations as tr

    asset = "manipulator_bring_ball"
    tm = tbase.load_model(asset, "cpu", torch.float64)
    jm = jax_model_from_asset(asset)
    site = tm.names.site["grasp"]
    arm = ["arm_root", "arm_shoulder", "arm_elbow", "arm_wrist"]
    adr = [tm.jnt_qposadr[tm.names.joint[j]] for j in arm]
    goal = tm.qpos0.numpy().copy()
    goal[adr] = [0.0, -0.6, 0.9, 0.4]
    d = tkin.kinematics(tm, make_data(tm, 1).replace(
        qpos=torch.tensor(goal)[None]))
    pos = d.site_xpos[0, site].numpy()
    quat = tr.mat_to_quat(d.site_xmat[0, site].numpy())
    start = tm.qpos0.numpy().copy()
    start[adr] = [0.0, 0.3, -0.4, 0.5]
    kwargs = dict(target_pos=pos, target_quat=quat, joint_names=arm[1:],
                  qpos0=start)
    t = tik.qpos_from_site_pose(tm, "grasp", **kwargs)
    j = jik.qpos_from_site_pose(jm, "grasp", **kwargs)
    assert t.success and j.success, (t, j)
    assert t.steps == j.steps
    np.testing.assert_allclose(t.qpos, np.asarray(j.qpos), rtol=0,
                               atol=1e-10)
    assert abs(t.err_norm - j.err_norm) <= 1e-10
