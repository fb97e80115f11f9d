"""Manipulator domain, batched (reference: dm_control/suite/manipulator.py).

A planar arm brings a ball or a peg to a target, or into a cup or slot.
Each task's model holds only its own props: the others are taken out of
the tree before it is compiled, as the JAX package's ``get_model`` does.
Every episode places the target, and the receptacle in the insert tasks,
anew: the task overrides ``body_pos`` and ``body_quat`` per environment,
(B, nbody, .).  The prop starts in the hand, in the target or anywhere.
With a torch generator the start is the JAX package's batched one, chosen
per environment from one draw, with every draw made; with a numpy
RandomState it is the reference's: a ``choice`` of the three, and the
draws of a start anywhere only where it is chosen.
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.physics import engine
from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics.model import make_data
from dm_control_torch.rl.control import apply_model_diff
from dm_control_torch.suite import base
from dm_control_torch.suite._domain import compile_domain_model
from dm_control_torch.suite.models.manipulator import MODEL
from dm_control_torch.utils import containers, rewards

TIME_LIMIT = 10
CONTROL_TIMESTEP = 0.01
_ALL_PROPS = frozenset(["ball", "target_ball", "cup", "peg", "target_peg",
                        "slot"])
_CLOSE = 0.01
_P_IN_HAND = 0.1
_P_IN_TARGET = 0.1
_ARM_JOINTS = ("arm_root", "arm_shoulder", "arm_elbow", "arm_wrist",
               "finger", "fingertip", "thumb", "thumbtip")
_TOUCH_SENSORS = ("palm_touch", "finger_touch", "thumb_touch",
                  "fingertip_touch", "thumbtip_touch")


def arm_ranges(m):
    """(lower, upper) (8,) of the arm's joints: a limited joint's range,
    else [-pi, pi]."""
    def build():
        lo, hi = [], []
        for name in _ARM_JOINTS:
            j = m.names.joint[name]
            r = m.jnt_range[j].cpu().tolist()
            limited = bool(m.jnt_limited[j])
            lo.append(r[0] if limited else -math.pi)
            hi.append(r[1] if limited else math.pi)
        return (m.const("arm_lower", lo), m.const("arm_upper", hi))
    return m.cached("arm_ranges", build)


def init_arm(m, qpos, rc):
    """qpos with the arm's angles drawn in their ranges, the finger's set
    to the thumb's."""
    lower, upper = arm_ranges(m)
    qadr = m.idx([m.jnt_qposadr[m.names.joint[j]] for j in _ARM_JOINTS])
    qpos = qpos.clone()
    qpos[:, qadr] = rc.uniform(lower, upper, len(_ARM_JOINTS))
    finger = m.jnt_qposadr[m.names.joint["finger"]]
    qpos[:, finger] = qpos[:, m.jnt_qposadr[m.names.joint["thumb"]]]
    return qpos


def arm_observations(m, d):
    """The arm's joint angles as (sin, cos) pairs (B, 8, 2) and its joint
    velocities (B, 8)."""
    joints = [m.names.joint[j] for j in _ARM_JOINTS]
    jp = d.qpos[:, m.idx([m.jnt_qposadr[j] for j in joints])]
    obs = collections.OrderedDict()
    obs["arm_pos"] = torch.stack([torch.sin(jp), torch.cos(jp)], -1)
    obs["arm_vel"] = d.qvel[:, m.idx([m.jnt_dofadr[j] for j in joints])]
    return obs


def body_2d_pose(m, d, name, orientation=True):
    """x and z of a body's position, and of its quaternion's w and y."""
    b = m.names.body[name]
    xz = m.idx([0, 2])
    pos = d.xpos[:, b][:, xz]
    return torch.cat([pos, d.xquat[:, b][:, xz]], -1) if orientation \
        else pos


class Bring(base.Task):
    """Bring the prop to the target (and into the receptacle)."""

    observation_stages = "acc"  # reads the touch sensors
    max_reset_rejections = 100

    def __init__(self, use_peg, insert, fully_observable):
        self._use_peg = use_peg
        self._target = "target_peg" if use_peg else "target_ball"
        self._object = "peg" if use_peg else "ball"
        self._object_joints = tuple(f"{self._object}_{dim}" for dim in "xzy")
        self._receptacle = "slot" if use_peg else "cup"
        self._insert = insert
        self._fully_observable = fully_observable

    def initial_model_diff(self, m):
        return {"body_pos": m.body_pos, "body_quat": m.body_quat}

    def reject(self, m, d):
        d = engine.fwd_position(m, d)
        return (d.contact.dist < 0).any(-1)

    def _grasp_site(self, m, qpos, diff):
        """Position and frame (B, 3), (B, 3, 3) of the grasp site at
        ``qpos`` on the model with ``diff``."""
        d = kin.kinematics(apply_model_diff(m, diff),
                           make_data(m, qpos.shape[0]).replace(qpos=qpos))
        sid = m.names.site["grasp"]
        return d.site_xpos[:, sid], d.site_xmat[:, sid]

    def init(self, m, qpos, qvel, rc, diff):
        B = rc.batch
        qpos = init_arm(m, qpos, rc)
        target_x = rc.uniform(-0.4, 0.4)
        target_z = rc.uniform(0.1, 0.4)
        bp = diff["body_pos"].expand(B, m.nbody, 3).clone()
        bq = diff["body_quat"].expand(B, m.nbody, 4).clone()
        bodies = [m.names.body[self._target]]
        if self._insert:
            target_angle = rc.uniform(-math.pi / 3, math.pi / 3)
            bodies.insert(0, m.names.body[self._receptacle])
        else:
            target_angle = rc.uniform(-math.pi, math.pi)
        for b in bodies:
            bp[:, b, 0] = target_x
            bp[:, b, 2] = target_z
            bq[:, b, 0] = torch.cos(target_angle / 2)
            bq[:, b, 2] = torch.sin(target_angle / 2)
        diff = dict(diff, body_pos=bp, body_quat=bq)

        if rc.is_numpy:
            return self._init_numpy(m, qpos, qvel, rc, diff, target_x,
                                    target_z, target_angle)
        u = rc.rand()
        spos, smat = self._grasp_site(m, qpos, diff)
        hand_angle = math.pi - torch.atan2(smat[:, 2, 0], smat[:, 0, 0])
        obj_ux = rc.uniform(-0.5, 0.5)
        obj_uz = rc.uniform(0.0, 0.7)
        obj_ua = rc.uniform(0.0, 2 * math.pi)
        vel_draw = rc.uniform(-5.0, 5.0)
        in_hand = u < _P_IN_HAND
        in_target = (u >= _P_IN_HAND) & (u < _P_IN_HAND + _P_IN_TARGET)

        def pick(hand, target, anywhere):
            return torch.where(in_hand, hand,
                               torch.where(in_target, target, anywhere))

        values = (pick(spos[:, 0], target_x, obj_ux),
                  pick(spos[:, 2], target_z, obj_uz),
                  pick(hand_angle, target_angle, obj_ua))
        qvel = qvel.clone()
        vdof = m.jnt_dofadr[m.names.joint[self._object + "_x"]]
        qvel[:, vdof] = torch.where(in_hand | in_target,
                                    torch.zeros_like(vel_draw), vel_draw)
        for name, val in zip(self._object_joints, values):
            qpos = self.set_joint_qpos(m, qpos, name, val)
        return qpos, qvel, diff

    def _init_numpy(self, m, qpos, qvel, rc, diff, target_x, target_z,
                    target_angle):
        """The prop's start as the reference draws it (one environment)."""
        init_type = rc.np_random.choice(
            ["in_hand", "in_target", "uniform"],
            p=[_P_IN_HAND, _P_IN_TARGET, 1 - _P_IN_HAND - _P_IN_TARGET])
        qvel = qvel.clone()
        if init_type == "in_target":
            values = (target_x, target_z, target_angle)
        elif init_type == "in_hand":
            spos, smat = self._grasp_site(m, qpos, diff)
            values = (spos[:, 0], spos[:, 2],
                      math.pi - torch.atan2(smat[:, 2, 0], smat[:, 0, 0]))
        else:
            values = (rc.uniform(-0.5, 0.5), rc.uniform(0, 0.7),
                      rc.uniform(0, 2 * math.pi))
            vdof = m.jnt_dofadr[m.names.joint[self._object + "_x"]]
            qvel[:, vdof] = rc.uniform(-5, 5)
        for name, val in zip(self._object_joints, values):
            qpos = self.set_joint_qpos(m, qpos, name, val)
        return qpos, qvel, diff

    def observation(self, m, d):
        obs = arm_observations(m, d)
        obs["touch"] = torch.log1p(torch.cat(
            [self.sensordata(m, d, s) for s in _TOUCH_SENSORS], dim=-1))
        if self._fully_observable:
            obs["hand_pos"] = body_2d_pose(m, d, "hand")
            obs["object_pos"] = body_2d_pose(m, d, self._object)
            obs["object_vel"] = d.qvel[:, m.idx(
                [m.jnt_dofadr[m.names.joint[j]]
                 for j in self._object_joints])]
            obs["target_pos"] = body_2d_pose(m, d, self._target)
        return obs

    def _site_distance(self, m, d, site1, site2):
        return torch.linalg.vector_norm(
            self.site_xpos(m, d, site1) - self.site_xpos(m, d, site2), dim=-1)

    def _is_close(self, distance):
        return rewards.tolerance(distance, (0, _CLOSE), _CLOSE * 2)

    def reward(self, m, d):
        if self._use_peg:
            grasp = self._is_close(
                self._site_distance(m, d, "peg_grasp", "grasp"))
            pinch = self._is_close(
                self._site_distance(m, d, "peg_pinch", "pinch"))
            grasping = (grasp + pinch) / 2
            bring = self._is_close(
                self._site_distance(m, d, "peg", "target_peg"))
            bring_tip = self._is_close(
                self._site_distance(m, d, "target_peg_tip", "peg_tip"))
            bringing = (bring + bring_tip) / 2
            return torch.maximum(bringing, grasping / 3)
        return self._is_close(self._site_distance(m, d, "ball",
                                                  "target_ball"))


def _mutate(root, use_peg, insert):
    required = (["peg", "target_peg"] + (["slot"] if insert else [])
                if use_peg else
                ["ball", "target_ball"] + (["cup"] if insert else []))
    for prop in _ALL_PROPS.difference(required):
        for e in list(root.iter()):
            for c in list(e.children):
                if c.tag == "body" and c.get("name") == prop:
                    e.children.remove(c)


def get_model(use_peg, insert, device=None,
              dtype: torch.dtype = torch.float64):
    """The model with the props of one task: a ball or a peg, with a cup
    or a slot to insert it into."""
    return compile_domain_model(
        MODEL, mutate=lambda r: _mutate(r, use_peg, insert),
        cache_key=(use_peg, insert), device=device, dtype=dtype)


def _model(use_peg, insert):
    name = "manipulator_{}_{}".format("insert" if insert else "bring",
                                      "peg" if use_peg else "ball")
    return base.Variant(name, lambda device, dtype: get_model(
        use_peg, insert, device, dtype))


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking", "hard")
def bring_ball(fully_observable=True):
    return _model(False, False), Bring(False, False, fully_observable)


@TASKS.add("hard")
def bring_peg(fully_observable=True):
    return _model(True, False), Bring(True, False, fully_observable)


@TASKS.add("hard")
def insert_ball(fully_observable=True):
    return _model(False, True), Bring(False, True, fully_observable)


@TASKS.add("hard")
def insert_peg(fully_observable=True):
    return _model(True, True), Bring(True, True, fully_observable)
