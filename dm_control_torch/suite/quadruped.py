"""Quadruped domain, batched (reference: dm_control/suite/quadruped.py).

Walk and run on a plane, escape a bumpy bowl, fetch a ball.  The four
tasks' models differ in the floor's size, the terrain with its
rangefinders, and the walls with the ball, set in the tree before it is
compiled as the JAX package's ``get_model`` sets them.  Escape draws its
terrain anew each episode: the task overrides ``hfield_data`` per
environment, (B, nrow, ncol).
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from dm_control_torch.physics import collision as coll
from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import JointType, SensorType, make_data
from dm_control_torch.rl.control import apply_model_diff
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.quadruped import MODEL
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 20
CONTROL_TIMESTEP = 0.02
_RUN_SPEED = 5
_WALK_SPEED = 0.5
_WALLS = ["wall_px", "wall_py", "wall_nx", "wall_ny"]
_TERRAIN_SMOOTHNESS = 0.15
_TERRAIN_BUMP_SCALE = 2
#: the root rises by this much a round until nothing penetrates, at most
#: ``_DROP_ROUNDS`` times
_DROP_STEP = 0.01
_DROP_ROUNDS = 1000


def _sensor_columns(m, *types):
    """The ``sensordata`` columns of the sensors of the given types, in
    the order of the sensors."""
    wanted = tuple(int(t) for t in types)
    return [m.sensor_adr[s] + k for s in range(m.nsensor)
            if m.sensor_type[s] in wanted for k in range(m.sensor_dim[s])]


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The (n_out, n_in) matrix that resamples a signal of ``n_in`` samples
    to ``n_out`` by cubic convolution with Keys' kernel (a = -0.5), sample
    centres at half-pixels, and the weights of a sample renormalised where
    the kernel leaves the signal: what ``jax.image.resize(...,
    method="cubic")`` applies along one axis when it enlarges."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


class _QuadrupedTask(base.Task):
    """What the four tasks share: the observations and the start pose."""

    observation_stages = "acc"  # reads the IMU and the force sensors

    #: rounds the last ``_drop_to_ground`` took (for profiles)
    last_drop_rounds = 0

    def _common_observations(self, m, d):
        hinges = [j for j in range(m.njnt)
                  if m.jnt_type[j] == int(JointType.HINGE)]
        qadr = m.idx([m.jnt_qposadr[j] for j in hinges])
        dadr = m.idx([m.jnt_dofadr[j] for j in hinges])
        obs = collections.OrderedDict()
        obs["egocentric_state"] = torch.cat(
            [d.qpos[:, qadr], d.qvel[:, dadr], d.act], dim=-1)
        obs["torso_velocity"] = self.sensordata(m, d, "velocimeter")
        obs["torso_upright"] = self.xmat(m, d, "torso", "zz")
        obs["imu"] = d.sensordata[:, m.idx(_sensor_columns(
            m, SensorType.GYRO, SensorType.ACCELEROMETER))]
        obs["force_torque"] = torch.arcsinh(d.sensordata[:, m.idx(
            _sensor_columns(m, SensorType.FORCE, SensorType.TORQUE))])
        return obs

    def _upright_reward(self, m, d, deviation_angle=0):
        deviation = math.cos(math.radians(deviation_angle))
        return rewards.tolerance(
            self.xmat(m, d, "torso", "zz"),
            bounds=(deviation, float("inf")), sigmoid="linear",
            margin=1 + deviation, value_at_margin=0)

    def _drop_to_ground(self, m, qpos, orientation, diff, xy=None):
        """qpos with the root at ``xy`` (B, 2; default the origin), turned
        to ``orientation`` (B, 4), at the lowest of the heights 0, 0.01,
        0.02, ... at which no contact penetrates.  Every environment stops
        rising at its own height, as if it were run alone; the loop ends
        when none rises (one ``.any()`` on the host per round).  Only the
        geom frames and the contacts are computed: nothing else of the
        position stage decides the height."""
        adr = m.jnt_qposadr[m.names.joint["root"]]
        B = qpos.shape[0]
        qpos = qpos.clone()
        qpos[:, adr:adr + 3] = 0.0
        if xy is not None:
            qpos[:, adr:adr + 2] = xy
        qpos[:, adr + 3:adr + 7] = orientation
        mm = apply_model_diff(m, diff)
        d0 = make_data(m, B, qpos.dtype)
        rising = torch.ones(B, dtype=torch.bool, device=qpos.device)
        rounds = 0
        while True:
            d = coll.collision(mm, kin.kinematics(mm, d0.replace(qpos=qpos)))
            rising = rising & (d.contact.dist < 0).any(-1)
            if rounds == _DROP_ROUNDS or not bool(rising.any()):
                break
            qpos[:, adr + 2] += _DROP_STEP * rising.to(qpos.dtype)
            rounds += 1
        self.last_drop_rounds = rounds
        return qpos


class Move(_QuadrupedTask):
    """Walk or run forward at a speed."""

    def __init__(self, desired_speed):
        self._desired_speed = desired_speed

    def init(self, m, qpos, qvel, rc, diff):
        orientation = mx.normalize(rc.randn(4), eps=0.0)
        return self._drop_to_ground(m, qpos, orientation, diff), qvel, diff

    def observation(self, m, d):
        return self._common_observations(m, d)

    def reward(self, m, d):
        move_reward = rewards.tolerance(
            self.sensordata(m, d, "velocimeter")[:, 0],
            bounds=(self._desired_speed, float("inf")),
            margin=self._desired_speed, value_at_margin=0.5,
            sigmoid="linear")
        return self._upright_reward(m, d) * move_reward


def _bowl(m):
    """The terrain's fixed bowl (nrow, ncol): 0 at the centre, 1 halfway
    out, 0 at the rim."""
    res = m.hfield_nrow
    row_grid, col_grid = np.ogrid[-1:1:res * 1j, -1:1:res * 1j]
    radius = np.clip(np.sqrt(col_grid ** 2 + row_grid ** 2), 0.04, 1)
    return 0.5 - np.cos(2 * np.pi * radius) / 2


class Escape(_QuadrupedTask):
    """Leave the bowl.  Each episode's terrain is the bowl times smoothed
    random bumps."""

    def initial_model_diff(self, m):
        return {"hfield_data": m.hfield_data}

    def init(self, m, qpos, qvel, rc, diff):
        res = m.hfield_nrow
        assert res == m.hfield_ncol
        terrain_size = m.cached("quadruped_terrain_size", lambda: 2 * float(
            m.hfield_size[0, 0]))
        bump_res = int(terrain_size / _TERRAIN_BUMP_SCALE)
        bumps = rc.uniform(_TERRAIN_SMOOTHNESS, 1, bump_res, bump_res)
        resize, bowl = m.cached("quadruped_terrain", lambda: (
            m.const("cubic_resize", cubic_resize_matrix(bump_res, res)),
            m.const("quadruped_bowl", _bowl(m))))
        if rc.is_numpy:  # the reference's spline zoom, on the host
            from scipy import ndimage

            smooth = torch.as_tensor(ndimage.zoom(
                bumps[0].cpu().numpy(), res / float(bump_res))).to(
                    bowl).unsqueeze(0)
        else:
            smooth = torch.einsum("oi,bij,pj->bop", resize, bumps, resize)
        terrain = bowl * smooth
        diff = dict(diff, hfield_data=terrain.to(m.hfield_data.dtype))
        orientation = mx.normalize(rc.randn(4), eps=0.0)
        return self._drop_to_ground(m, qpos, orientation, diff), qvel, diff

    def observation(self, m, d):
        obs = self._common_observations(m, d)
        torso = m.names.body["torso"]
        obs["origin"] = -mx.mat_t_vec(d.xmat[:, torso], d.xpos[:, torso])
        rf = d.sensordata[:, m.idx(_sensor_columns(
            m, SensorType.RANGEFINDER))]
        obs["rangefinder"] = torch.where(rf == -1.0, torch.ones_like(rf),
                                         torch.tanh(rf))
        return obs

    def reward(self, m, d):
        terrain_size = m.cached("quadruped_escape_size", lambda: float(
            m.hfield_size[0, 0]))
        origin_dist = mx.norm(self.site_xpos(m, d, "workspace"))
        escape_reward = rewards.tolerance(
            origin_dist, bounds=(terrain_size, float("inf")),
            margin=terrain_size, value_at_margin=0, sigmoid="linear")
        return self._upright_reward(m, d, deviation_angle=20) * escape_reward


class Fetch(_QuadrupedTask):
    """Bring the ball to the target.  The walker starts anywhere in the
    arena, turned about the vertical; the ball is tossed in from above."""

    def _sizes(self, m):
        names = m.names
        return m.derived("quadruped_fetch_sizes", "site_size", lambda: dict(
            floor=float(m.geom_size[names.geom["floor"], 0]),
            ball=float(m.geom_size[names.geom["ball"], 0]),
            workspace=float(m.site_size[names.site["workspace"], 0]),
            target=float(m.site_size[names.site["target"], 0])))

    def init(self, m, qpos, qvel, rc, diff):
        half = rc.uniform(0, 2 * math.pi) / 2
        zero = torch.zeros_like(half)
        orientation = torch.stack([torch.cos(half), zero, zero,
                                   torch.sin(half)], dim=-1)
        spawn_radius = 0.9 * self._sizes(m)["floor"]
        qpos = self._drop_to_ground(
            m, qpos, orientation, diff,
            xy=rc.uniform(-spawn_radius, spawn_radius, 2))
        ball = m.names.joint["ball_root"]
        adr, dof = m.jnt_qposadr[ball], m.jnt_dofadr[ball]
        qpos[:, adr:adr + 2] = rc.uniform(-spawn_radius, spawn_radius, 2)
        qpos[:, adr + 2] = 2.0
        qvel = qvel.clone()
        qvel[:, dof:dof + 2] = 5 * rc.randn(2)
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = self._common_observations(m, d)
        torso = m.names.body["torso"]
        torso_frame = d.xmat[:, torso]
        torso_pos = d.xpos[:, torso]
        root = m.jnt_dofadr[m.names.joint["root"]]
        ball = m.jnt_dofadr[m.names.joint["ball_root"]]
        ball_state = torch.stack([
            d.xpos[:, m.names.body["ball"]] - torso_pos,
            d.qvel[:, ball:ball + 3] - d.qvel[:, root:root + 3],
            d.qvel[:, ball + 3:ball + 6]], dim=1)  # (B, 3, 3)
        obs["ball_state"] = torch.einsum(
            "bki,bij->bkj", ball_state, torso_frame).reshape(-1, 9)
        obs["target_position"] = mx.mat_t_vec(
            torso_frame, self.site_xpos(m, d, "target") - torso_pos)
        return obs

    def reward(self, m, d):
        size = self._sizes(m)
        arena_radius = size["floor"] * math.sqrt(2.0)
        ball_pos = d.xpos[:, m.names.body["ball"]]
        reach_reward = rewards.tolerance(
            mx.norm((self.site_xpos(m, d, "workspace") - ball_pos)[:, :2]),
            bounds=(0, size["workspace"] + size["ball"]), sigmoid="linear",
            margin=arena_radius, value_at_margin=0)
        fetch_reward = rewards.tolerance(
            mx.norm((self.site_xpos(m, d, "target") - ball_pos)[:, :2]),
            bounds=(0, size["target"]), sigmoid="linear",
            margin=arena_radius, value_at_margin=0)
        reach_then_fetch = reach_reward * (0.5 + 0.5 * fetch_reward)
        return self._upright_reward(m, d) * reach_then_fetch


def _mutate(root, floor_size=None, terrain=False, rangefinders=False,
            walls_and_ball=False):
    """Reference quadruped.py make_model: prune task-specific content."""

    def remove_named(tag, name):
        for e in list(root.iter()):
            for c in list(e.children):
                if c.tag == tag and c.get("name") == name:
                    e.children.remove(c)

    if floor_size is not None:
        for e in root.iter():
            if e.tag == "geom" and e.get("name") == "floor":
                e.attrib["size"] = f"{floor_size} {floor_size} .5"
    if not walls_and_ball:
        for wall in _WALLS:
            remove_named("geom", wall)
        remove_named("body", "ball")
        remove_named("site", "target")
    if not terrain:
        remove_named("geom", "terrain")
    if not rangefinders:
        for e in root.iter():
            e.children[:] = [c for c in e.children
                             if c.tag != "rangefinder"]


def get_model(device=None, dtype: torch.dtype = torch.float64, **kwargs):
    """The model with the floor, terrain, rangefinders, walls and ball that
    ``kwargs`` ask for (``_mutate``)."""
    key = tuple(sorted(kwargs.items()))
    return compile_domain_model(
        MODEL, mutate=lambda r: _mutate(r, **kwargs), cache_key=key,
        device=device, dtype=dtype)


def _model(name, **kwargs):
    return base.Variant(name, lambda device, dtype: get_model(
        device, dtype, **kwargs))


TASKS = containers.TaggedTasks()


@TASKS.add()
def walk():
    return _model("quadruped_walk",
                  floor_size=TIME_LIMIT * _WALK_SPEED), Move(_WALK_SPEED)


@TASKS.add()
def run():
    return _model("quadruped_run",
                  floor_size=TIME_LIMIT * _RUN_SPEED), Move(_RUN_SPEED)


@TASKS.add()
def escape():
    return _model("quadruped_escape", floor_size=40, terrain=True,
                  rangefinders=True), Escape()


@TASKS.add()
def fetch():
    return _model("quadruped_fetch", walls_and_ball=True), Fetch()
