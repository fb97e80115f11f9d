"""Finger domain, batched (reference: dm_control/suite/finger.py).

A two-link planar finger flicks a spinner on a hinge with friction loss.
Every episode sets the hinge's damping to 0.03, a per-environment
``dof_damping`` (B, nv); Turn also places its target on a circle about the
hinge (``site_pos``) and sets its size (``site_size``).
"""

from __future__ import annotations

import collections
import math

import torch

from dm_control_torch.physics import engine
from dm_control_torch.suite import base
from dm_control_torch.suite.utils import randomizers
from dm_control_torch.utils import containers

TIME_LIMIT = 20
CONTROL_TIMESTEP = 0.02
_EASY_TARGET_SIZE = 0.07
_HARD_TARGET_SIZE = 0.03
_SPIN_VELOCITY = 15.0


class _FingerTask(base.Task):
    """What Spin and Turn share: the start pose, which is drawn again
    until nothing penetrates, and the observations."""

    observation_stages = "acc"  # reads the touch sensors
    max_reset_rejections = 1000

    def initial_model_diff(self, m):
        damping = m.dof_damping.clone()
        damping[m.jnt_dofadr[m.names.joint["hinge"]]] = 0.03
        return {"dof_damping": damping}

    def init(self, m, qpos, qvel, rc, diff):
        diff = dict(diff, dof_damping=diff["dof_damping"].expand(
            rc.batch, m.nv).clone())
        qpos = randomizers.randomize_limited_and_rotational_joints(
            m, qpos, rc)
        return qpos, qvel, diff

    def reject(self, m, d):
        d = engine.fwd_position(m, d)
        return (d.contact.dist < 0).any(-1)

    def reject_reinit(self, m, qpos, qvel, rc, diff):
        """The reference draws the joints again, not the target."""
        return _FingerTask.init(self, m, qpos, qvel, rc, diff)

    def _xz(self, m, d, sensor):
        return self.sensordata(m, d, sensor)[:, m.idx([0, 2])]

    def _tip_position(self, m, d):
        return self._xz(m, d, "tip") - self._xz(m, d, "spinner")

    def _observation(self, m, d):
        obs = collections.OrderedDict()
        obs["position"] = torch.cat([
            self.sensordata(m, d, "proximal"), self.sensordata(m, d, "distal"),
            self._tip_position(m, d)], dim=-1)
        obs["velocity"] = torch.cat([
            self.sensordata(m, d, "proximal_velocity"),
            self.sensordata(m, d, "distal_velocity"),
            self.sensordata(m, d, "hinge_velocity")], dim=-1)
        obs["touch"] = torch.log1p(torch.cat([
            self.sensordata(m, d, "touchtop"),
            self.sensordata(m, d, "touchbottom")], dim=-1))
        return obs


class Spin(_FingerTask):
    """Spin the body on the hinge faster than 15 rad/s."""

    def observation(self, m, d):
        return self._observation(m, d)

    def reward(self, m, d):
        hinge_vel = self.sensordata(m, d, "hinge_velocity")[:, 0]
        return (hinge_vel <= -_SPIN_VELOCITY).to(d.qpos.dtype)


class Turn(_FingerTask):
    """Turn the spinner's tip into the target."""

    def __init__(self, target_radius):
        self._target_radius = target_radius

    def initial_model_diff(self, m):
        size = m.site_size.clone()
        size[m.names.site["target"], 0] = self._target_radius
        return dict(super().initial_model_diff(m), site_size=size,
                    site_pos=m.site_pos)

    def _hinge_circle(self, m):
        """(x, z) of the hinge's anchor, which no joint moves, and the
        radius of the circle the target lies on."""
        def build():
            jid = m.names.joint["hinge"]
            body_pos = m.body_pos.cpu().tolist()
            anchor = m.jnt_pos[jid].cpu().tolist()
            b = m.jnt_bodyid[jid]
            while b != 0:
                anchor = [a + p for a, p in zip(anchor, body_pos[b])]
                b = m.body_parentid[b]
            cap1 = m.geom_size[m.names.geom["cap1"]]
            return anchor[0], anchor[2], float(cap1.sum())
        return m.derived("finger_hinge_circle", "body_pos", build)

    def init(self, m, qpos, qvel, rc, diff):
        target_angle = rc.uniform(-math.pi, math.pi)
        hinge_x, hinge_z, radius = self._hinge_circle(m)
        sid = m.names.site["target"]
        sp = diff["site_pos"].expand(rc.batch, m.nsite, 3).clone()
        sp[:, sid, 0] = hinge_x + radius * torch.sin(target_angle)
        sp[:, sid, 2] = hinge_z + radius * torch.cos(target_angle)
        diff = dict(diff, site_pos=sp, site_size=diff["site_size"].expand(
            rc.batch, m.nsite, 3).clone())
        return super().init(m, qpos, qvel, rc, diff)

    def _target_position(self, m, d):
        return self._xz(m, d, "target") - self._xz(m, d, "spinner")

    def _dist_to_target(self, m, d):
        to_target = self._target_position(m, d) - self._tip_position(m, d)
        return (torch.linalg.vector_norm(to_target, dim=-1)
                - m.site_size[..., m.names.site["target"], 0])

    def observation(self, m, d):
        obs = self._observation(m, d)
        obs["target_position"] = self._target_position(m, d)
        obs["dist_to_target"] = self._dist_to_target(m, d)
        return obs

    def reward(self, m, d):
        return (self._dist_to_target(m, d) <= 0).to(d.qpos.dtype)


TASKS = containers.TaggedTasks()


@TASKS.add("benchmarking")
def spin():
    return "finger", Spin()


@TASKS.add("benchmarking")
def turn_easy():
    return "finger", Turn(_EASY_TARGET_SIZE)


@TASKS.add("benchmarking")
def turn_hard():
    return "finger", Turn(_HARD_TARGET_SIZE)
