"""The frame sensors the Duplo brick declares (FRAMEQUAT, FRAMELINVEL,
FRAMEANGVEL, beside FRAMEPOS) and ``mathx.mat_to_quat`` against the JAX
package, in float64 on the CPU.

The states are the brick of the manipulation models (reach_duplo,
lift_brick) turned by quaternions from a numpy seed (among them turns by
pi, where w is 0 and Shepperd's method leaves the largest pivot, and
turns with w within 1e-7 of 0), moving with velocities from the same
seed.  The port's position and velocity stages run, then the port's
sensors and the JAX package's ``sensor_pos``/``sensor_vel`` on that Data
(converted field by field, so no JAX physics is compiled): equal to
1e-12.  The sensors' objects are the brick's bounding-box site, as
declared, and in the other cases a body (the brick's, and an arm link's,
whose tree has another root) and a geom.  A quaternion and its negation
are one rotation: where |w| < 1e-6 the sign can flip between two
roundings of the same frame, and there either sign passes; elsewhere
both sides give w > 0.
"""

import numpy as np
import pytest
import torch

import test_torch_tasks as tasks
from _torch_helpers import export_tool, jax_model_from_asset
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import mathx as tmx
from dm_control_torch.physics import model_io
from dm_control_torch.physics import sensors as tsens
from dm_control_torch.physics.model import ObjType, SensorType, make_data

ATOL = 1e-12
#: |w| below which a quaternion's sign is left open
SIGN_OPEN = 1e-6
FRAME = (SensorType.FRAMEPOS, SensorType.FRAMEQUAT, SensorType.FRAMELINVEL,
         SensorType.FRAMEANGVEL)


def _quats(n, rng):
    """n unit quaternions: random ones, turns by pi about random axes (w
    = 0) and turns by pi minus 1e-7 (w ~ 5e-8), in both signs."""
    q = rng.normal(size=(n, 4))
    k = n // 4
    axes = rng.normal(size=(2 * k, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    q[:k] = np.concatenate([np.zeros((k, 1)), axes[:k]], 1)
    half = (np.pi - 1e-7) / 2
    q[k:2 * k] = np.concatenate([np.full((k, 1), np.cos(half)),
                                 np.sin(half) * axes[k:]], 1)
    q[1::2] *= -1
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _assert_quats_close(got, want):
    """Equal within ATOL, or equal up to sign where |w| < SIGN_OPEN."""
    got, want = np.asarray(got), np.asarray(want)
    same = np.abs(got - want).max(-1)
    flipped = np.abs(got + want).max(-1)
    open_sign = np.abs(want[..., 0]) < SIGN_OPEN
    ok = (same <= ATOL) | (open_sign & (flipped <= ATOL))
    assert ok.all(), (same[~ok], flipped[~ok])
    assert (want[..., 0][~open_sign] > 0).all()


def test_mat_to_quat_matches_jax():
    from dm_control_tpu.physics import mathx as jmx

    q = _quats(64, np.random.default_rng(0))
    mat = tmx.quat_to_mat(torch.as_tensor(q))
    got = tmx.mat_to_quat(mat).numpy()
    _assert_quats_close(got, jmx.mat_to_quat(mat.numpy()))
    # the rotation comes back, in the canonical sign
    canon = np.where(q[:, :1] < 0, -q, q)
    _assert_quats_close(got, canon)
    assert (np.abs(got[:, 0]) < SIGN_OPEN).sum() >= 16


def _retarget(m, kind, bodies):
    """The model with the frame sensors' objects moved to ``kind`` ("site":
    as declared; "body": FRAMEPOS and FRAMEQUAT on the brick's body, the
    velocities on an arm link's; "geom": all on a geom of the brick)."""
    if kind == "site":
        return m
    brick = m.names.body["brick/brick"]
    geom = next(g for g in range(m.ngeom) if m.geom_bodyid[g] == brick)
    objtype, objid = list(m.sensor_objtype), list(m.sensor_objid)
    for s in range(m.nsensor):
        stype = SensorType(m.sensor_type[s])
        if stype not in FRAME:
            continue
        if kind == "body":
            velocity = stype in (SensorType.FRAMELINVEL,
                                 SensorType.FRAMEANGVEL)
            objtype[s] = int(ObjType.BODY if velocity else ObjType.XBODY)
            objid[s] = bodies["arm"] if velocity else brick
        else:
            objtype[s], objid[s] = int(ObjType.GEOM), geom
    return m.replace(sensor_objtype=tuple(objtype),
                     sensor_objid=tuple(objid))


@pytest.mark.parametrize("kind", ["site", "body", "geom"])
@pytest.mark.parametrize("asset", ["reach_duplo", "lift_brick"])
def test_frame_sensors_match_jax(asset, kind):
    import jax

    from dm_control_tpu.physics import sensors as jsens

    tm = model_io.load(export_tool().asset_path(asset), "cpu", torch.float64)
    bodies = {"arm": tm.names.body["arm/b_4"]}
    assert tm.body_rootid[bodies["arm"]] != tm.body_rootid[
        tm.names.body["brick/brick"]]
    tm = _retarget(tm, kind, bodies)
    jm = _retarget(jax_model_from_asset(asset), kind, bodies)
    n = 16
    rng = np.random.default_rng(5)
    adr = tm.jnt_qposadr[tm.names.joint["brick/brick_root"]]
    qpos = tm.qpos0.expand(n, tm.nq).clone()
    qpos[:, adr:adr + 3] = torch.as_tensor(rng.uniform(-0.2, 0.2, (n, 3)))
    qpos[:, adr + 3:adr + 7] = torch.as_tensor(_quats(n, rng))
    d = make_data(tm, n).replace(
        qpos=qpos, qvel=torch.as_tensor(rng.normal(size=(n, tm.nv))))
    d = tsens.sensor_pos(tm, tengine.fwd_position(tm, d))
    d = tsens.sensor_vel(tm, tengine.fwd_velocity(tm, d))
    jd = tasks.jax_data(jm, d)
    want = np.asarray(jax.vmap(lambda dd: jsens.sensor_vel(
        jm, jsens.sensor_pos(jm, dd)).sensordata)(jd))
    got = d.sensordata.numpy()
    seen = set()
    for s in range(tm.nsensor):
        stype = SensorType(tm.sensor_type[s])
        if stype not in FRAME:
            continue
        seen.add(stype)
        cols = slice(tm.sensor_adr[s], tm.sensor_adr[s] + tm.sensor_dim[s])
        assert np.abs(got[:, cols]).max(-1).min() > 1e-3, stype.name
        if stype == SensorType.FRAMEQUAT:
            _assert_quats_close(got[:, cols], want[:, cols])
        else:
            np.testing.assert_allclose(got[:, cols], want[:, cols], rtol=0,
                                       atol=ATOL, err_msg=stype.name)
    assert seen == set(FRAME)
