"""Composer's initializers and the position detector of the port against
the JAX package's, in float64 on the CPU, from equal ``RandomState``s.

- ``PropPlacer``: two boxes placed over a floor where they may overlap,
  each drawn again while a contact penetrates: the poses and the
  generator's state after; ``ignore_collisions`` takes the first draw;
  a region too small raises.
- ``ToolCenterPointInitializer``: manipulator's grasp site put at a drawn
  pose by inverse kinematics: qpos within 1e-10 and the generator's
  state.
- ``PositionDetector``: which positions lie inside its box, and its
  position, on a compiled arena.

The JAX package's physics is its ``Physics`` on the port's compiled
model (``jax_model_from_port``); nothing is jit-compiled.  The JAX
placer's position stage is the port's (its draws and tests are what is
held).
"""

import numpy as np
import pytest
import torch

from _torch_helpers import jax_model_from_asset, jax_model_from_port
from dm_control_torch.composer import initializers as tinit
from dm_control_torch.composer import variation as tvariation
from dm_control_torch.entities.props import position_detector as tdetector
from dm_control_torch.entities.props import primitive as tprimitive
from dm_control_torch.locomotion import arenas as tarenas
from dm_control_torch.physics.physics import Physics as TPhysics
from dm_control_torch.suite import base as tbase


def _jax():
    from dm_control_tpu.composer import initializers, variation
    from dm_control_tpu.entities.props import position_detector, primitive
    from dm_control_tpu.locomotion import arenas

    return initializers, variation, position_detector, primitive, arenas


def _jax_physics(model):
    from dm_control_tpu.physics import physics as jphysics
    from dm_control_tpu.physics.model import make_data

    jm = jax_model_from_port(model)
    return jphysics.Physics(jm, make_data(jm))


def _boxes(arenas, primitive):
    """A floor and two free boxes, apart and above it (the placer redraws
    while any contact of the model penetrates); the entities built in the
    same order in both packages, so their names agree."""
    arena = arenas.Floor(size=(2, 2))
    boxes = [primitive.Primitive(geom_type="box", size=(0.1, 0.1, 0.1),
                                 name=f"box{i}") for i in range(2)]
    for i, box in enumerate(boxes):
        arena.add_free_entity(box).attrib["pos"] = f"{3 * i - 1.5} 1.5 0.5"
    return arena, boxes


def _placers(low, high, monkeypatch, **kwargs):
    """The port's and the JAX package's placers of two boxes over
    ``Uniform(low, high)``, with their physics.  The JAX placer's position
    stage is the port's on the JAX state (its contacts' distances handed
    back): the placers' draws and tests are held, not the collision, which
    ``test_torch_collision.py`` holds, and nothing of JAX's is
    compiled."""
    import types

    import jax.numpy as jnp

    from dm_control_tpu.physics import engine as jengine
    from dm_control_torch.physics import engine as tengine

    jinit, jvariation, _, jprimitive, jarenas = _jax()
    arena, boxes = _boxes(tarenas, tprimitive)
    jarena, jboxes = _boxes(jarenas, jprimitive)
    physics = TPhysics.from_mjcf_model(arena.mjcf_model, device="cpu")
    jphysics = _jax_physics(physics.model)

    def fwd_position(m, d):
        port = TPhysics(physics.model)
        port.set_data(qpos=np.asarray(d.qpos))
        dist = tengine.fwd_position(port.model, port._data).contact.dist
        return types.SimpleNamespace(contact=types.SimpleNamespace(
            dist=jnp.asarray(dist[0].numpy())))

    monkeypatch.setattr(jengine, "fwd_position", fwd_position)
    placer = tinit.PropPlacer(boxes, tvariation.distributions.Uniform(
        low, high), **kwargs)
    jplacer = jinit.PropPlacer(jboxes, jvariation.distributions.Uniform(
        low, high), **kwargs)
    return (placer, physics), (jplacer, jphysics)


@pytest.mark.parametrize("seed", [0, 4])
def test_prop_placer_matches_jax(seed, monkeypatch):
    """Boxes 0.2 wide drawn in a square 0.5 wide: the second often lands in
    the first and is drawn again.  The poses (free joints' qpos) and the
    generator's state after the placement agree exactly."""
    low, high = [-0.25, -0.25, 0.15], [0.25, 0.25, 0.15]
    ours, theirs = _placers(low, high, monkeypatch)
    draws = []
    for (placer, physics), rs in ((ours, np.random.RandomState(seed)),
                                  (theirs, np.random.RandomState(seed))):
        placer(physics, rs)
        draws.append(rs)
    np.testing.assert_array_equal(ours[1].data.qpos.numpy(),
                                  np.asarray(theirs[1].data.qpos))
    np.testing.assert_array_equal(draws[0].get_state()[1],
                                  draws[1].get_state()[1])
    q = ours[1].data.qpos.numpy().reshape(2, 7)
    assert np.abs(q[0, :2] - q[1, :2]).max() >= 0.2  # apart


def test_prop_placer_ignoring_collisions_and_giving_up(monkeypatch):
    """``ignore_collisions`` keeps the first draw, even into the other box;
    a region that forces an overlap raises after ``max_attempts``."""
    low = high = [0.0, 0.0, 0.15]
    (placer, physics), (jplacer, jphysics) = _placers(
        low, high, monkeypatch, ignore_collisions=True)
    placer(physics, np.random.RandomState(0))
    jplacer(jphysics, np.random.RandomState(0))
    np.testing.assert_array_equal(physics.data.qpos.numpy(),
                                  np.asarray(jphysics.data.qpos))
    (placer, physics), (jplacer, jphysics) = _placers(
        low, high, monkeypatch, max_attempts_per_prop=3)
    for p, ph in ((placer, physics), (jplacer, jphysics)):
        with pytest.raises(RuntimeError, match="box1"):
            p(ph, np.random.RandomState(0))


def test_tcp_initializer_matches_jax():
    """manipulator's grasp site to a pose drawn around one the arm reaches
    (the orientation of that configuration, the position within 2 cm in
    the arm's plane), by the arm's three joints: the placed qpos within
    1e-10, the generator's state equal."""
    from dm_control_tpu.composer.initializers import tcp_initializer
    from dm_control_tpu.composer.variation import distributions as jdist
    from dm_control_tpu.physics import physics as jphysics
    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_torch.physics import kinematics as tkin
    from dm_control_torch.physics.model import make_data
    from dm_control_torch.utils import transformations as tr

    asset = "manipulator_bring_ball"
    tm = tbase.load_model(asset, "cpu", torch.float64)
    arm = ["arm_shoulder", "arm_elbow", "arm_wrist"]
    adr = [int(tm.jnt_qposadr[tm.names.joint[j]]) for j in arm]
    goal = tm.qpos0.numpy().copy()
    goal[adr] = [-0.6, 0.9, 0.4]
    d = tkin.kinematics(tm, make_data(tm, 1).replace(
        qpos=torch.tensor(goal)[None]))
    site = tm.names.site["grasp"]
    pos = d.site_xpos[0, site].numpy()
    quat = tr.mat_to_quat(d.site_xmat[0, site].numpy())
    low, high = pos - [0.02, 0.0, 0.02], pos + [0.02, 0.0, 0.02]
    start = tm.qpos0.numpy().copy()
    start[adr] = [-0.5, 0.8, 0.5]
    physics = TPhysics(tm)
    physics.set_data(qpos=start)
    jm = jax_model_from_asset(asset)
    jp = jphysics.Physics(jm, jmake_data(jm))
    jp._data = jp.data.replace(qpos=np.asarray(start))
    ours = tinit.ToolCenterPointInitializer(
        "grasp", arm, tvariation.distributions.Uniform(low, high),
        quaternion=quat)
    theirs = tcp_initializer.ToolCenterPointInitializer(
        "grasp", arm, jdist.Uniform(low, high), quaternion=quat)
    rs, jrs = np.random.RandomState(1), np.random.RandomState(1)
    ours(physics, rs)
    theirs(jp, jrs)
    np.testing.assert_allclose(physics.data.qpos.numpy(),
                               np.asarray(jp.data.qpos), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(rs.get_state()[1], jrs.get_state()[1])
    reached = physics.data.site_xpos[site].numpy()
    assert np.all(low - 1e-9 <= reached) and np.all(reached <= high + 1e-9)


def test_position_detector_matches_jax():
    """The positions inside the detector's box (its half-sizes), and its
    world position, on a floor arena compiled by the port."""
    _, _, jdetector, _, jarenas = _jax()
    dets = []
    for arenas, det in ((tarenas, tdetector), (jarenas, jdetector)):
        arena = arenas.Floor(size=(2, 2))
        detector = det.PositionDetector(pos=(0.5, -0.2, 0.3),
                                        size=(0.2, 0.1, 0.3))
        arena.attach(detector)
        dets.append((arena, detector))
    physics = TPhysics.from_mjcf_model(dets[0][0].mjcf_model, device="cpu")
    physics.forward()
    jp = _jax_physics(physics.model)
    jp._data = jp.data.replace(xpos=np.asarray(physics.data.xpos.numpy()))
    points = [(0.5, -0.2, 0.3), (0.69, -0.11, 0.01), (0.71, -0.2, 0.3),
              (0.5, -0.31, 0.3), (0.3, -0.1, 0.6), (0.0, 0.0, 0.0)]
    for (_, detector), ph in zip(dets, (physics, jp)):
        detector.initialize_episode(ph, None)
        assert detector.detected == ()
    got = [detector.update(ph, points)
           for (_, detector), ph in zip(dets, (physics, jp))]
    assert got[0] == got[1] == [0, 1, 4]
    assert dets[0][1].detected == dets[1][1].detected == (0, 1, 4)
    np.testing.assert_array_equal(dets[0][1].site_pos(physics),
                                  np.asarray(dets[1][1].site_pos(jp)))
    np.testing.assert_array_equal(dets[0][1].site_pos(physics),
                                  [0.5, -0.2, 0.3])
