"""Dog domain, batched (reference: dm_control/suite/dog.py).

Stand, walk, trot and run on a plane, and fetch a thrown ball.  The model
runs the noslip post-pass (``opt.noslip_iterations`` 4) and reads the
acceleration stage (touch, force and IMU sensors).  Each episode starts
with random actuator activations (``init_act``).  Each task's model sets
the floor's half-size (the distance the task asks for) and, but for
fetch, takes the ball, its target, its cameras and the walls out of the
tree before it is compiled, as the JAX package's ``_make_model`` does.
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import JointType, make_data
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.dog import MODEL
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 15
CONTROL_TIMESTEP = .015
_MIN_UPRIGHT_COSINE = math.cos(math.radians(30))
_STAND_HEIGHT_FRACTION = 0.9
_WALK_SPEED = 1
_TROT_SPEED = 3
_RUN_SPEED = 9


def _pose_consts(m):
    """(stand heights of torso and pelvis, body weight), from the model at
    ``qpos0``."""
    def build():
        xpos = kin.kinematics(m, make_data(m, 1)).xpos[0].cpu().numpy()
        names = m.names.body
        height = xpos[[names["torso"], names["pelvis"]], 2] \
            * _STAND_HEIGHT_FRACTION
        weight = (-float(m.opt.gravity[2])
                  * float(m.body_subtreemass[names["torso"]]))
        return tuple(float(h) for h in height), weight

    return m.cached("dog_pose_consts", build)


def _hinges(m):
    """The hinge joints' qpos and dof addresses."""
    def build():
        hinges = [j for j in range(m.njnt)
                  if m.jnt_type[j] == int(JointType.HINGE)]
        return (m.idx([m.jnt_qposadr[j] for j in hinges]),
                m.idx([m.jnt_dofadr[j] for j in hinges]))

    return m.cached("dog_hinges", build)


def _point_linvel(m, d, point, body):
    """World linear velocity (B, 3) of a point (B, 3) fixed to ``body``."""
    com = d.subtree_com[:, m.body_rootid[body]]
    return mx.transform_motion(d.cvel[:, body], point - com)[..., 3:]


def _in_frame(vec, frame):
    """vec (B, 3) in the axes of frame (B, 3, 3): vec @ frame."""
    return torch.einsum("bi,bij->bj", vec, frame)


class Stand(base.Task):
    """Upright posture with the feet loaded."""

    observation_stages = "acc"  # reads the touch, force and IMU sensors

    def init(self, m, qpos, qvel, rc, diff):
        half = rc.uniform(0, 2 * math.pi) / 2
        qpos = qpos.clone()
        qpos[:, 3] = torch.cos(half)
        qpos[:, 4:6] = 0.0
        qpos[:, 6] = torch.sin(half)
        qvel = qvel.clone()
        for dof in (0, 1, 5):
            qvel[:, dof] = 2 * rc.randn()
        return qpos, qvel, diff

    def init_act(self, m, rc):
        ctrlrange = m.actuator_ctrlrange
        return rc.uniform(ctrlrange[:, 0], ctrlrange[:, 1], m.nu)

    def _sensors(self, m, d, names):
        return torch.cat([self.sensordata(m, d, s) for s in names], -1)

    def _torso_pelvis_height(self, m, d):
        return d.xpos[:, m.idx([m.names.body["torso"],
                                m.names.body["pelvis"]]), 2]

    def _z_projection(self, m, d):
        return d.xmat[:, m.idx([m.names.body[b] for b in
                                ("skull", "torso", "pelvis")]), 2, :]

    def _torso_com_velocity(self, m, d):
        return _in_frame(self.sensordata(m, d, "torso_linvel"),
                         d.xmat[:, m.names.body["torso"]])

    def _touch_sensors(self, m, d):
        return self._sensors(m, d, ("palm_L", "palm_R", "sole_L", "sole_R"))

    def observation(self, m, d):
        qadr, dadr = _hinges(m)
        obs = collections.OrderedDict()
        obs["joint_angles"] = d.qpos[:, qadr]
        # the reference's key has this typo (dog.py:300)
        obs["joint_velocites"] = d.qvel[:, dadr]
        obs["torso_pelvis_height"] = self._torso_pelvis_height(m, d)
        obs["z_projection"] = self._z_projection(m, d).reshape(-1, 9)
        obs["torso_com_velocity"] = self._torso_com_velocity(m, d)
        obs["inertial_sensors"] = self._sensors(
            m, d, ("accelerometer", "velocimeter", "gyro"))
        obs["foot_forces"] = self._sensors(
            m, d, ("foot_L", "foot_R", "hand_L", "hand_R"))
        obs["touch_sensors"] = self._touch_sensors(m, d)
        obs["actuator_state"] = d.act
        return obs

    def reward_factors(self, m, d):
        """(B, 6): torso height, pelvis height, three upright cosines,
        the feet's load."""
        stand_height, body_weight = _pose_consts(m)
        height = self._torso_pelvis_height(m, d)
        torso = rewards.tolerance(height[:, 0],
                                  bounds=(stand_height[0], float("inf")),
                                  margin=stand_height[0])
        pelvis = rewards.tolerance(height[:, 1],
                                   bounds=(stand_height[1], float("inf")),
                                   margin=stand_height[1])
        upright = rewards.tolerance(self._z_projection(m, d)[..., 2],
                                    bounds=(_MIN_UPRIGHT_COSINE, float("inf")),
                                    sigmoid="linear",
                                    margin=_MIN_UPRIGHT_COSINE + 1,
                                    value_at_margin=0)
        touch = rewards.tolerance(torch.sum(self._touch_sensors(m, d), -1),
                                  bounds=(body_weight, float("inf")),
                                  margin=body_weight, sigmoid="linear",
                                  value_at_margin=0.9)
        return torch.cat([torso.unsqueeze(-1), pelvis.unsqueeze(-1),
                          upright, touch.unsqueeze(-1)], -1)

    def reward(self, m, d):
        return torch.prod(self.reward_factors(m, d), -1)


class Move(Stand):
    """Locomotion at a target speed."""

    def __init__(self, move_speed):
        self._move_speed = move_speed

    def reward_factors(self, m, d):
        speed = self._move_speed
        forward = rewards.tolerance(self._torso_com_velocity(m, d)[:, 0],
                                    bounds=(speed, 2 * speed),
                                    margin=max(1.0, speed),
                                    value_at_margin=0, sigmoid="linear")
        forward = (4 * forward + 1) / 5
        return torch.cat([super().reward_factors(m, d),
                          forward.unsqueeze(-1)], -1)


class Fetch(Stand):
    """Fetch a thrown ball to the target."""

    def init(self, m, qpos, qvel, rc, diff):
        qpos, qvel, diff = super().init(m, qpos, qvel, rc, diff)
        radius = 0.75 * float(m.geom_size[m.names.geom["floor"], 0])
        azimuth = rc.uniform(0, 2 * math.pi)
        ball = m.names.joint["ball_root"]
        adr, dof = m.jnt_qposadr[ball], m.jnt_dofadr[ball]
        qpos[:, adr] = radius * torch.sin(azimuth)
        qpos[:, adr + 1] = radius * torch.cos(azimuth)
        qpos[:, adr + 2] = 0.05
        vertical_height = rc.uniform(0, 3)
        gravity = -float(m.opt.gravity[2])
        horizontal_speed = rc.uniform(0, 5)
        dx = -torch.sin(azimuth) + 0.05 * rc.randn()
        dy = -torch.cos(azimuth) + 0.05 * rc.randn()
        qvel[:, dof] = horizontal_speed * dx
        qvel[:, dof + 1] = horizontal_speed * dy
        qvel[:, dof + 2] = torch.sqrt(2 * gravity * vertical_height)
        return qpos, qvel, diff

    def _head(self, m, d):
        head = m.names.site["head"]
        return head, d.site_xpos[:, head], d.site_xmat[:, head]

    def observation(self, m, d):
        obs = super().observation(m, d)
        head, head_pos, head_frame = self._head(m, d)
        ball = m.names.geom["ball"]
        ball_pos = d.geom_xpos[:, ball]
        head_to_ball_vel = (
            _point_linvel(m, d, ball_pos, m.geom_bodyid[ball])
            - _point_linvel(m, d, head_pos, m.site_bodyid[head]))
        obs["ball_state"] = torch.cat([
            _in_frame(ball_pos - head_pos, head_frame),
            _in_frame(head_to_ball_vel, head_frame)], -1)
        obs["target_position"] = _in_frame(
            d.geom_xpos[:, m.names.geom["target"]] - head_pos, head_frame)
        return obs

    def _sizes(self, m):
        names = m.names
        return m.cached("dog_fetch_sizes", lambda: (
            float(m.site_size[names.site["upper_bite"], 0]),
            float(m.geom_size[names.geom["target"], 0]),
            float(m.geom_size[names.geom["floor"], 0])))

    def reward_factors(self, m, d):
        bite_radius, target_radius, bring_margin = self._sizes(m)
        ball = d.geom_xpos[:, m.names.geom["ball"]]
        mouth = 0.5 * (
            mx.norm(ball - self.site_xpos(m, d, "upper_bite"))
            + mx.norm(ball - self.site_xpos(m, d, "lower_bite")))
        reach_ball = rewards.tolerance(mouth, bounds=(0, bite_radius),
                                       sigmoid="reciprocal", margin=2)
        reach_ball = (6 * reach_ball + 1) / 7
        dist = mx.norm(ball - d.geom_xpos[:, m.names.geom["target"]])
        near_target = rewards.tolerance(dist, bounds=(0, target_radius),
                                        sigmoid="reciprocal",
                                        margin=bring_margin)
        fetch_ball = (near_target + 1) / 2
        # the ball counts as brought once it is near the target
        reach_ball = torch.where(dist < 2 * target_radius,
                                 torch.ones_like(reach_ball), reach_ball)
        return torch.cat([super().reward_factors(m, d),
                          reach_ball.unsqueeze(-1),
                          fetch_ball.unsqueeze(-1)], -1)


def _make_model(floor_size, remove_ball, device=None,
                dtype: torch.dtype = torch.float64):
    """The model with a floor of half-size ``floor_size``, without the
    ball, its target, its cameras and the walls if ``remove_ball``
    (reference dog.py:61 ``make_model``)."""

    def mutate(root):
        floor = root.find("geom", "floor")
        floor.attrib["size"] = f"{floor_size} {floor_size} .1"
        if remove_ball:
            ball = root.find("body", "ball")
            ball.parent.remove(ball)
            for tag, name in (("geom", "target"), ("camera", "ball"),
                              ("camera", "head")):
                el = root.find(tag, name)
                el.parent.remove(el)
            for wall in ("px", "nx", "py", "ny"):
                el = root.find("geom", "wall_" + wall)
                el.parent.remove(el)

    return compile_domain_model(MODEL, mutate=mutate,
                                cache_key=(floor_size, remove_ball),
                                device=device, dtype=dtype)


def _model(name, floor_size, remove_ball=True):
    return base.Variant(name, lambda device, dtype: _make_model(
        floor_size, remove_ball, device, dtype))


TASKS = containers.TaggedTasks()


@TASKS.add("no_reward_visualization")
def stand():
    return _model("dog", _WALK_SPEED * TIME_LIMIT), Stand()


@TASKS.add("no_reward_visualization")
def walk():
    return _model("dog", _WALK_SPEED * TIME_LIMIT), Move(_WALK_SPEED)


@TASKS.add("no_reward_visualization")
def trot():
    return (_model("dog_trot", _TROT_SPEED * TIME_LIMIT),
            Move(_TROT_SPEED))


@TASKS.add("no_reward_visualization")
def run():
    return _model("dog_run", _RUN_SPEED * TIME_LIMIT), Move(_RUN_SPEED)


@TASKS.add("no_reward_visualization", "hard")
def fetch():
    return _model("dog_fetch", 10, remove_ball=False), Fetch()
