"""The N-vs-N soccer task, batched (counterpart of
``dm_control_tpu/locomotion/soccer/task.py``).

Every player observes the match in its own frame; a goal pays +1 to each
player of the scoring team and -1 to each of the other, ends the episode
with discount 0, and the autoreset kicks off anew.  The actions of all
players are one vector, player after player.  Only the batched hooks are
ported (``composer.BatchableTask``): the host hooks, the throw-in and the
possession trackers belong to composer's host path (ROADMAP A5).
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from dm_control_torch.composer.batch import BatchableTask
from dm_control_torch.locomotion import asset_path
from dm_control_torch.locomotion.soccer.boxhead import BoxHead
from dm_control_torch.locomotion.soccer.pitch import Pitch
from dm_control_torch.locomotion.soccer.soccer_ball import SoccerBall
from dm_control_torch.locomotion.soccer.team import Player, Team

_INIT_BALL_Z = 0.5
_SPAWN_RATIO = 0.6
#: (team size, pitch size) of each checked-in match: BoxHead players
#: ``home0, ..., away0, ...``, the default ball, walker contacts on
ASSETS = {(1, (12, 9)): "soccer_1v1", (2, (12, 9)): "soccer_2v2"}


def standard_players(team_size):
    """Home and away teams of ``team_size`` BoxHead players each, named
    ``home<i>`` and ``away<i>``, home first."""
    return ([Player(Team.HOME, BoxHead(name=f"home{i}"))
             for i in range(team_size)]
            + [Player(Team.AWAY, BoxHead(name=f"away{i}"))
               for i in range(team_size)])


class Task(BatchableTask):
    """N-vs-N soccer with goal rewards, one per player."""

    def __init__(self, players, arena, ball=None,
                 disable_walker_contacts=False, physics_timestep=0.005,
                 control_timestep=0.025):
        self.arena = arena
        self.players = list(players)
        self.ball = ball or SoccerBall()
        self.disable_walker_contacts = disable_walker_contacts
        self.physics_timestep = physics_timestep
        self.control_timestep = control_timestep
        self.batch_reward_shape = (len(self.players),)

    @property
    def model_asset(self):
        """The checked-in model of this match; the others need the MJCF
        compiler (ROADMAP A9)."""
        n = len(self.players) // 2
        standard = (
            type(self.arena) is Pitch and self.arena._goal_size is None
            and not self.disable_walker_contacts
            and [(p.team, type(p.walker), p.walker.name)
                 for p in self.players]
            == [(p.team, BoxHead, p.walker.name)
                for p in standard_players(n)]
            and vars(self.ball) == vars(SoccerBall()))
        key = (n, tuple(self.arena.size))
        if not standard or key not in ASSETS:
            raise NotImplementedError(
                f"soccer: no compiled model of this match ({n} a side on a "
                f"{tuple(self.arena.size)} pitch; checked in: "
                f"{sorted(ASSETS)} with BoxHead players, the default ball "
                f"and walker contacts on); compiling others needs the MJCF "
                f"compiler (ROADMAP A9)")
        return asset_path(ASSETS[key])

    # -- batched path (composer.batch.BatchableTask) ------------------------

    def _batch_layout(self, m):
        """Addresses and constants of the match in model ``m``, built once
        per model."""
        return m.cached(("soccer_layout", self.ball.name, tuple(
            p.walker.name for p in self.players)), lambda: self._build(m))

    def _build(self, m):
        names = m.names
        ball_j = next(j for n, j in names.joint.items()
                      if n.startswith(self.ball.name) and n.endswith("_root"))

        def joints(w, js):
            ids = [names.joint[f"{w.name}/{j}"] for j in js]
            return ([int(m.jnt_qposadr[j]) for j in ids],
                    [int(m.jnt_dofadr[j]) for j in ids])

        root_q, root_d, jnt_q, jnt_d, steer_q, root_bid = [], [], [], [], \
            [], []
        for p in self.players:
            w = p.walker
            q, v = joints(w, ("root_x", "root_y", "root_z"))
            root_q.append(q)
            root_d.append(v)
            q, v = joints(w, w.observable_joint_names)
            jnt_q.append(q)
            jnt_d.append(v)
            steer_q.append(joints(w, ("steer",))[0][0])
            root_bid.append(names.body[f"{w.name}/{w.root_body_name}"])
        n = len(self.players)
        home = [p.team == Team.HOME for p in self.players]
        others = [[j for j in range(n) if j != i] for i in range(n)]
        a = self.arena
        own = [a.home_goal.mid if h else a.away_goal.mid for h in home]
        opp = [a.away_goal.mid if h else a.home_goal.mid for h in home]
        front = [a.field.upper if h else a.field.lower for h in home]
        back = [a.field.lower if h else a.field.upper for h in home]
        spawn = np.asarray(a.size, float) * _SPAWN_RATIO
        key = ("soccer",) + tuple(p.walker.name for p in self.players)

        def const(name, value):
            return m.const(key + (name,), np.asarray(value, float))

        return dict(
            ball_qadr=int(m.jnt_qposadr[ball_j]),
            ball_dof=m.idx(range(int(m.jnt_dofadr[ball_j]),
                                 int(m.jnt_dofadr[ball_j]) + 6)),
            ball_bid=int(m.jnt_bodyid[ball_j]),
            root_q=root_q, steer_q=steer_q,
            root_d=m.idx(root_d).reshape(n, 3), root_bid=m.idx(root_bid),
            jnt_q=m.idx(jnt_q).reshape(n, -1),
            jnt_d=m.idx(jnt_d).reshape(n, -1),
            others=m.idx(others).reshape(n, n - 1) if n > 1 else None,
            teammate_mask=const("mask", [[float(home[j] == home[i])
                                          for j in others[i]]
                                         for i in range(n)]),
            team_sign=const("sign", [1.0 if h else -1.0 for h in home]),
            own_mid=const("own", own), opp_mid=const("opp", opp),
            front=const("front", front), back=const("back", back),
            home_goal=(const("home_lo", a.home_goal.lower),
                       const("home_hi", a.home_goal.upper)),
            away_goal=(const("away_lo", a.away_goal.lower),
                       const("away_hi", a.away_goal.upper)),
            spawn_lo=const("spawn_lo", -spawn), spawn_hi=const("spawn_hi",
                                                               spawn))

    def batch_init(self, m, qpos, qvel, rc, diff):
        """The ball dropped from 0.5 m and every player at a uniform
        point of the spawn box (0.6 of the pitch), turned by a uniform
        yaw; drawn ball first, then player by player."""
        lay = self._batch_layout(m)
        lo, hi = lay["spawn_lo"], lay["spawn_hi"]
        qpos = qpos.clone()
        bxy = rc.uniform(lo, hi, 2)
        a = lay["ball_qadr"]
        qpos[:, a:a + 2] = bxy
        qpos[:, a + 2] = _INIT_BALL_Z
        for (qx, qy, _), steer in zip(lay["root_q"], lay["steer_q"]):
            xy = rc.uniform(lo, hi, 2)
            yaw = rc.uniform(-math.pi, math.pi)
            qpos[:, qx] = xy[:, 0]
            qpos[:, qy] = xy[:, 1]
            qpos[:, steer] = yaw
        return qpos, qvel, diff

    @staticmethod
    def _goals(lay, d):
        """(ball inside the home goal, inside the away goal), (B,) each;
        the bounds are inside."""
        p = d.xpos[:, lay["ball_bid"]]

        def inside(box):
            return ((p >= box[0]) & (p <= box[1])).all(-1)
        return inside(lay["home_goal"]), inside(lay["away_goal"])

    def batch_observation(self, m, d):
        lay = self._batch_layout(m)
        B = d.qpos.shape[0]
        R = d.xmat[:, lay["root_bid"]]  # (B, n, 3, 3): body -> world
        pos = d.xpos[:, lay["root_bid"]]  # (B, n, 3)
        vel = d.qvel[:, lay["root_d"]]  # (B, n, 3)

        def ego(vec):  # R^T vec of every player, vec (B, n, ..., 3)
            return torch.einsum("bnji,bn...j->bn...i", R, vec)

        ball = d.qvel[:, lay["ball_dof"]]
        ball_pos = d.xpos[:, lay["ball_bid"]].unsqueeze(1)  # (B, 1, 3)
        zero = torch.zeros_like(pos[..., :1])

        def ego_xy(corner):  # a point of the field, z = 0, seen in (x, y)
            return ego(torch.cat([corner - pos[..., :2], zero], -1))[..., :2]

        per_player = collections.OrderedDict(
            joints_pos=d.qpos[:, lay["jnt_q"]],
            joints_vel=d.qvel[:, lay["jnt_d"]],
            ball_ego_position=ego(ball_pos - pos),
            ball_ego_linear_velocity=ego(ball[:, None, :3] - vel),
            ball_ego_angular_velocity=ego(ball[:, None, 3:].expand_as(vel)),
            team_goal_mid=ego(lay["own_mid"] - pos),
            opponent_goal_mid=ego(lay["opp_mid"] - pos),
            field_front_left=ego_xy(lay["front"]),
            field_back_right=ego_xy(lay["back"]))
        if lay["others"] is not None:
            others = lay["others"]
            per_player["others_ego_position"] = ego(
                pos[:, others] - pos.unsqueeze(2)).flatten(2)
            per_player["others_ego_linear_velocity"] = ego(
                vel[:, others] - vel.unsqueeze(2)).flatten(2)
            per_player["teammate_mask"] = lay["teammate_mask"].expand(
                B, -1, -1)
        to_ball = ball_pos[..., :2] - pos[..., :2]
        dist = torch.linalg.vector_norm(to_ball, dim=-1)
        toward = ((to_ball / dist.clamp(min=1e-6).unsqueeze(-1))
                  * vel[..., :2]).sum(-1)
        per_player["stats_vel_to_ball"] = torch.where(
            dist > 1e-6, toward, torch.zeros_like(toward))
        obs = collections.OrderedDict()
        for i in range(len(self.players)):
            for k, v in per_player.items():
                obs[f"player_{i}/{k}"] = v[:, i]
        return obs

    def batch_reward(self, m, d):
        """(B, n_players): +1 for the scoring team, -1 for the other."""
        lay = self._batch_layout(m)
        in_home, in_away = self._goals(lay, d)  # a home goal: away scored
        score = in_away.to(d.qpos.dtype) - in_home.to(d.qpos.dtype)
        return score.unsqueeze(-1) * lay["team_sign"]

    def batch_termination(self, m, d):
        lay = self._batch_layout(m)
        in_home, in_away = self._goals(lay, d)
        scored = in_home | in_away
        return scored, torch.where(scored, torch.zeros_like(d.time),
                                   torch.ones_like(d.time))


class MultiturnTask(Task):
    """Play through goals until the time limit: a goal re-kicks off
    inside the episode.  That runs on the host, with composer's host path
    (ROADMAP A5); the batched path of a match ends its episode at a goal,
    so ``compile_task`` refuses this task."""

    @property
    def model_asset(self):
        raise NotImplementedError(
            "soccer.MultiturnTask re-kicks off inside an episode on "
            "composer's host path (ROADMAP A5); the batched path ends the "
            "episode at a goal (soccer.Task)")
