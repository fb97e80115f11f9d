"""The N-vs-N soccer task (counterpart of
``dm_control_tpu/locomotion/soccer/task.py``; reference:
dm_control/locomotion/soccer/task.py:36-267).

Every player observes the match in its own frame; a goal pays +1 to each
player of the scoring team and -1 to each of the other and ends the
episode with discount 0.  The actions of all players are one vector,
player after player (``action_spec_per_player`` gives the per-player
view, and ``before_step`` takes either).

Two paths over one task: the host hooks (``composer.Environment``: the
initializer, the throw-in, the possession trackers fed by the contacts,
the goal detectors, the observables), and the batched hooks
(``composer.BatchableTask``: thousands of matches in lockstep on the
device, whose autoreset kicks off anew after a goal).  Tracking cameras
(``soccer.MultiplayerTrackingCamera``) follow the ball and the players on
the host path and render on the physics' device.
"""

from __future__ import annotations

import collections
import enum
import math

import numpy as np
import torch

from dm_control_torch import composer
from dm_control_torch.composer.batch import BatchableTask
from dm_control_torch.locomotion.soccer import initializers as initializers_lib
from dm_control_torch.locomotion.soccer import observables as observables_lib
from dm_control_torch.locomotion.soccer.boxhead import BoxHead
from dm_control_torch.locomotion.soccer.humanoid import Humanoid
from dm_control_torch.locomotion.soccer.soccer_ball import SoccerBall
from dm_control_torch.locomotion.soccer.team import (
    RGBA_BLUE, RGBA_RED, Player, Team,
)
from dm_control_torch.locomotion.walkers.ant import Ant
from dm_control_torch.rl import specs

_THROW_IN_BALL_Z = 0.5
_INIT_BALL_Z = 0.5
_SPAWN_RATIO = 0.6


class WalkerType(enum.Enum):
    BOXHEAD = 0
    ANT = 1
    HUMANOID = 2


_WALKER_TYPE_ALIASES = {"boxhead": WalkerType.BOXHEAD,
                        "ant": WalkerType.ANT,
                        "humanoid": WalkerType.HUMANOID}


def walker_type_of(walker_type):
    """A ``WalkerType``, or one named by a string in any case."""
    if isinstance(walker_type, str):
        return _WALKER_TYPE_ALIASES[walker_type.lower()]
    return walker_type


def _make_walker(name, walker_id, marker_rgba,
                 walker_type=WalkerType.BOXHEAD):
    """One player's walker (reference soccer/__init__.py:54-77)."""
    if walker_type == WalkerType.BOXHEAD:
        return BoxHead(name=name, walker_id=walker_id,
                       marker_rgba=marker_rgba)
    if walker_type == WalkerType.ANT:
        return Ant(name=name, marker_rgba=marker_rgba)
    if walker_type == WalkerType.HUMANOID:
        return Humanoid(name=name, marker_rgba=list(marker_rgba),
                        walker_id=walker_id, visual=Humanoid.Visual.JERSEY)
    raise ValueError(f"Unrecognized walker type: {walker_type}")


def standard_players(team_size, walker_type=WalkerType.BOXHEAD):
    """Home and away teams of ``team_size`` players each of ``walker_type``
    (a ``WalkerType`` or its name), named ``home<i>`` and ``away<i>`` with
    the team colours, home first, as the JAX package's ``soccer.load``
    builds them."""
    walker_type = walker_type_of(walker_type)
    home, away = [], []
    for i in range(team_size):
        home.append(Player(Team.HOME, _make_walker(
            f"home{i}", i, RGBA_BLUE, walker_type)))
        away.append(Player(Team.AWAY, _make_walker(
            f"away{i}", i, RGBA_RED, walker_type)))
    return home + away


def _disable_geom_contacts(entities):
    """Zeroes contype on every geom of the entities (reference
    task.py:36-41)."""
    for entity in entities:
        for geom in entity.mjcf_model.find_all("geom"):
            geom.attrib["contype"] = "0"


class Task(composer.Task, BatchableTask):
    """N-vs-N soccer with goal rewards, one per player (reference
    task.py:44-233)."""

    def __init__(self, players, arena, ball=None, initializer=None,
                 observables=None, disable_walker_contacts=False,
                 physics_timestep=0.005, control_timestep=0.025,
                 tracking_cameras=()):
        self.arena = arena
        self.players = list(players)
        self._initializer = (initializer
                             or initializers_lib.UniformInitializer())
        self._observables_adder = (
            observables or observables_lib.CoreObservablesAdder())
        if disable_walker_contacts:
            _disable_geom_contacts([p.walker for p in self.players])
        self.ball = ball or SoccerBall()
        arena.add_free_entity(self.ball)
        if hasattr(arena, "register_ball"):
            arena.register_ball(self.ball)
        self._scores = {Team.HOME: 0, Team.AWAY: 0}
        self._task_observables = collections.OrderedDict()
        self._player_index = {id(p): i for i, p in enumerate(self.players)}
        for player in self.players:
            arena.add_free_entity(player.walker)
            self.ball.register_player(player)
            self._observables_adder(self, player)
        self._tracking_cameras = tuple(tracking_cameras)
        # one reward per player on the batched path
        self.batch_reward_shape = (len(self.players),)
        self.set_timesteps(control_timestep, physics_timestep)

    def add_player_observable(self, player, name, observable):
        """Registers an observable under ``player_{i}/{name}``, enabled."""
        observable.enabled = True
        i = self._player_index[id(player)]
        self._task_observables[f"player_{i}/{name}"] = observable

    @property
    def root_entity(self):
        return self.arena

    # -- episode ------------------------------------------------------------

    def initialize_episode_mjcf(self, random_state):
        self.arena.initialize_episode_mjcf(random_state)

    def after_compile(self, physics, random_state):
        super().after_compile(physics, random_state)
        for camera in self._tracking_cameras:
            camera.after_compile(physics)

    def _tracked_entity_positions(self, physics):
        """The ball's and every player's position (what the tracking
        cameras follow)."""
        positions = [np.asarray(self.ball.get_pose(physics)[0])]
        for player in self.players:
            positions.append(np.asarray(player.walker.get_pose(physics)[0]))
        return positions

    def initialize_episode(self, physics, random_state):
        self.arena.initialize_episode(physics, random_state)
        self.ball.initialize_episode(physics, random_state)
        self._initializer(self, physics, random_state)
        if hasattr(self.arena, "update_detection"):
            self.arena.update_detection(physics)
        for camera in self._tracking_cameras:
            camera.initialize_episode(
                self._tracked_entity_positions(physics))

    # -- actions ------------------------------------------------------------

    def action_spec_per_player(self, physics):
        """One ``BoundedArray`` a player (the reference's spec shape,
        soccer/task.py:210)."""
        full = physics.action_spec()
        nu_each = full.shape[0] // max(len(self.players), 1)
        out = []
        for i in range(len(self.players)):
            sl = slice(i * nu_each, (i + 1) * nu_each)
            out.append(specs.BoundedArray(
                shape=(nu_each,), dtype=full.dtype,
                minimum=full.minimum[sl], maximum=full.maximum[sl],
                name=f"player_{i}"))
        return out

    def _throw_in(self, physics, random_state, ball):
        """Puts an off-court ball back toward the field (reference
        task.py:118-126)."""
        x, y, _ = np.asarray(ball.position(physics))
        shrink_x, shrink_y = random_state.uniform([0.7, 0.7], [0.9, 0.9])
        ball.set_pose(physics, [x * shrink_x, y * shrink_y,
                                _THROW_IN_BALL_Z])
        ball.set_velocity(physics, velocity=np.zeros(3),
                          angular_velocity=np.zeros(3))
        ball.initialize_entity_trackers()

    def before_step(self, physics, action, random_state):
        if isinstance(action, (list, tuple)):
            action = np.concatenate([np.asarray(a).ravel() for a in action])
        physics.set_control(action)
        if (hasattr(self.arena, "detected_off_court")
                and self.arena.detected_off_court()):
            self._throw_in(physics, random_state, self.ball)

    # -- scoring ------------------------------------------------------------

    def _update_ball_contacts(self, physics):
        """Feeds the ball's possession tracker with the player-ball
        contacts of the last step (one copy of the contact distances from
        the device)."""
        self.ball.clear_step_flags()
        m = physics.model
        ball_geoms = {gid for name, gid in m.names.geom.items()
                      if name.startswith(self.ball.name)}
        if not ball_geoms:
            return
        contact = physics.data.contact
        active = np.where(contact.dist.cpu().numpy() < 0)[0]
        if not len(active):
            return
        g1, g2 = np.asarray(contact.geom1), np.asarray(contact.geom2)
        geom_owner = {}
        for player in self.players:
            prefix = player.walker.name
            for name, gid in m.names.geom.items():
                if name.startswith(prefix):
                    geom_owner[gid] = player
        last = self.ball.last_hit
        ball_pos = self.ball.position(physics)
        for k in active:
            a, b = int(g1[k]), int(g2[k])
            player = None
            if a in ball_geoms:
                player = geom_owner.get(b)
            elif b in ball_geoms:
                player = geom_owner.get(a)
            if player is not None:
                teammate = (last is not None
                            and last.team == player.team)
                self.ball.update_hit(player, teammate, position=ball_pos)

    def after_step(self, physics, random_state):
        self._update_ball_contacts(physics)
        if hasattr(self.arena, "update_detection"):
            self.arena.update_detection(physics)
        scored = self.arena.detected_goal()
        if scored is not None:
            self._scores[scored] += 1
        for camera in self._tracking_cameras:
            camera.after_step(self._tracked_entity_positions(physics))

    @property
    def scores(self):
        return dict(self._scores)

    def get_reward(self, physics):
        """+1 for the scoring team's players, -1 for the other's, one
        float32 a player (reference task.py:138-165)."""
        del physics
        scoring_team = self.arena.detected_goal()
        if scoring_team is None:
            return [np.zeros((), np.float32) for _ in self.players]
        return [np.ones((), np.float32) if p.team == scoring_team
                else -np.ones((), np.float32) for p in self.players]

    def get_reward_spec(self):
        return [specs.Array(name="reward", shape=(), dtype=np.float32)
                for _ in self.players]

    def get_discount(self, physics):
        del physics
        if self.arena.detected_goal() is not None:
            return np.zeros((), np.float32)
        return np.ones((), np.float32)

    def get_discount_spec(self):
        return specs.Array(name="discount", shape=(), dtype=np.float32)

    def should_terminate_episode(self, physics):
        del physics
        return self.arena.detected_goal() is not None

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
    """Play through goals until the time limit: a goal re-kicks off inside
    the episode (reference task.py:236-267).  That needs the host, so the
    batched path, whose episodes end at a goal, refuses this task
    (``composer.compile_task`` raises ``TypeError``)."""

    batch_observation = BatchableTask.batch_observation

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._should_reset = False

    def should_terminate_episode(self, physics):
        del physics
        return False

    def get_discount(self, physics):
        del physics
        return np.ones((), np.float32)

    def before_step(self, physics, action, random_state):
        super().before_step(physics, action, random_state)
        if self._should_reset:
            self.ball.initialize_entity_trackers()
            self._should_reset = False

    def after_step(self, physics, random_state):
        super().after_step(physics, random_state)
        if self.arena.detected_goal() is not None:
            self._initializer(self, physics, random_state)
            # the goal's detection stays, so this step's reward pays it;
            # only the off-court state is refreshed for the next step
            if hasattr(self.arena, "field"):
                self.arena.field.update(physics)
            self._should_reset = True
