"""Per-player soccer observables (counterpart of
``dm_control_tpu/locomotion/soccer/observables.py``; reference:
dm_control/locomotion/soccer/observables.py:16-425).

Adders are callables ``adder(task, player)`` that register egocentric
observables for one player.  Registration goes through
``task.add_player_observable`` so every observable lands in the task's
flat observation dict under a ``player_{i}/`` prefix (our composer
collects task observables rather than mutating walker objects: the
same keys, one level up).  Each observable reads the physics on the host
(``Physics.named_field``, a copy from its device)."""

from __future__ import annotations

import abc

import numpy as np

from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.locomotion.soccer.team import Team


class ObservablesAdder(abc.ABC):
    """A callable that adds a set of per-player observables for a task."""

    @abc.abstractmethod
    def __call__(self, task, player):
        """Adds observables to `player` for the given `task`."""


class MultiObservablesAdder(ObservablesAdder):
    """Applies multiple `ObservablesAdder`s (reference
    observables.py:36-56)."""

    def __init__(self, observables):
        self._observables = list(observables)

    def __call__(self, task, player):
        for observable in self._observables:
            observable(task, player)


class CoreObservablesAdder(ObservablesAdder):
    """Core set of per-player observables (reference
    observables.py:58-350): proprioception, egocentric ball state,
    egocentric other-player state, arena landmarks, and game stats."""

    def __call__(self, task, player):
        self._add_player_proprio_observables(task, player)
        self._add_player_observables_on_ball(task, player, task.ball)
        teammate_id = opponent_id = 0
        for other in task.players:
            if other is player:
                continue
            if player.team != other.team:
                prefix = f"opponent_{opponent_id}"
                opponent_id += 1
            else:
                prefix = f"teammate_{teammate_id}"
                teammate_id += 1
            self._add_player_observables_on_other(
                task, player, other, prefix)
        self._add_aggregated_others(task, player)
        self._add_player_arena_observables(task, player, task.arena)
        self._add_player_stats_observables(task, player)

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _ego(player, physics, vec):
        return player.walker.transform_vec_to_egocentric_frame(physics, vec)

    def _add_player_proprio_observables(self, task, player):
        del task
        player.walker.observables.enable_proprioception()

    def _add_player_observables_on_ball(self, task, player, ball):
        walker = player.walker

        def ball_ego_position(physics):
            return self._ego(player, physics,
                             ball.position(physics)
                             - walker.root_xpos(physics))

        def ball_ego_linear_velocity(physics):
            return self._ego(player, physics,
                             ball.linear_velocity(physics)
                             - walker.root_linear_velocity(physics))

        def ball_ego_angular_velocity(physics):
            return self._ego(player, physics,
                             ball.angular_velocity(physics))

        task.add_player_observable(
            player, "ball_ego_position", Generic(ball_ego_position))
        task.add_player_observable(
            player, "ball_ego_linear_velocity",
            Generic(ball_ego_linear_velocity))
        task.add_player_observable(
            player, "ball_ego_angular_velocity",
            Generic(ball_ego_angular_velocity))

    def _add_player_observables_on_other(self, task, player, other,
                                         prefix):
        """Egocentric observables of another player (reference
        observables.py:90-137)."""
        walker = player.walker

        def ego_position(physics):
            return self._ego(player, physics,
                             other.walker.root_xpos(physics)
                             - walker.root_xpos(physics))

        def ego_linear_velocity(physics):
            return self._ego(
                player, physics,
                other.walker.root_linear_velocity(physics)
                - walker.root_linear_velocity(physics))

        def ego_orientation(physics):
            return (walker.root_xmat(physics).T
                    @ other.walker.root_xmat(physics)).ravel()

        task.add_player_observable(
            player, f"{prefix}_ego_position", Generic(ego_position))
        task.add_player_observable(
            player, f"{prefix}_ego_linear_velocity",
            Generic(ego_linear_velocity))
        task.add_player_observable(
            player, f"{prefix}_ego_orientation", Generic(ego_orientation))

        ee_names = other.walker.end_effector_body_names
        if ee_names:
            def ego_end_effectors_pos(physics):
                origin = walker.root_xpos(physics)
                out = []
                for name in ee_names:
                    p = np.asarray(physics.named_field(
                        "xpos", other.walker._prefixed(name)))
                    out.append(self._ego(player, physics, p - origin))
                return np.hstack(out)

            task.add_player_observable(
                player, f"{prefix}_ego_end_effectors_pos",
                Generic(ego_end_effectors_pos))

    def _add_aggregated_others(self, task, player):
        """Flat all-others views (batched-path-friendly aggregates kept
        alongside the reference per-other keys)."""
        walker = player.walker
        others = [p for p in task.players if p is not player]

        def others_ego_position(physics):
            root = walker.root_xpos(physics)
            out = [self._ego(player, physics,
                             o.walker.root_xpos(physics) - root)
                   for o in others]
            return np.hstack(out) if out else np.zeros(0)

        def others_ego_linear_velocity(physics):
            mine = walker.root_linear_velocity(physics)
            out = [self._ego(player, physics,
                             o.walker.root_linear_velocity(physics) - mine)
                   for o in others]
            return np.hstack(out) if out else np.zeros(0)

        def teammate_mask(physics):
            del physics
            return np.array([1.0 if o.team == player.team else 0.0
                             for o in others])

        task.add_player_observable(
            player, "others_ego_position", Generic(others_ego_position))
        task.add_player_observable(
            player, "others_ego_linear_velocity",
            Generic(others_ego_linear_velocity))
        task.add_player_observable(
            player, "teammate_mask", Generic(teammate_mask))

    def _add_player_arena_observables(self, task, player, arena):
        """Egocentric goal/field landmark vectors, ordered clockwise from
        the player's own goal (reference observables.py:160-205)."""
        walker = player.walker
        clockwise_names = [
            "team_goal_back_right", "team_goal_mid", "team_goal_front_left",
            "field_front_left", "opponent_goal_back_left",
            "opponent_goal_mid", "opponent_goal_front_right",
            "field_back_right",
        ]

        def landmark(feature_fn, three_d=False):
            def obs(physics):
                target = np.asarray(feature_fn(), float)
                origin = walker.root_xpos(physics)
                if not three_d:
                    target = np.append(target[:2], origin[2] * 0.0)
                    delta = np.append(target[:2] - origin[:2], 0.0)
                else:
                    delta = target - origin
                return self._ego(player, physics, delta)
            return Generic(obs)

        clockwise_features = [
            (lambda: arena.home_goal.lower[:2], False),
            (lambda: arena.home_goal.mid, True),
            (lambda: arena.home_goal.upper[:2], False),
            (lambda: arena.field.upper, False),
            (lambda: arena.away_goal.upper[:2], False),
            (lambda: arena.away_goal.mid, True),
            (lambda: arena.away_goal.lower[:2], False),
            (lambda: arena.field.lower, False),
        ]
        if player.team != Team.HOME:
            half = len(clockwise_features) // 2
            clockwise_features = (clockwise_features[half:]
                                  + clockwise_features[:half])
        for name, (fn, three_d) in zip(clockwise_names,
                                       clockwise_features):
            task.add_player_observable(player, name, landmark(fn, three_d))

    def _add_player_stats_observables(self, task, player):
        """Game statistics (reference observables.py:207-350)."""
        walker = player.walker
        ball = task.ball

        def _vel_to_ball(physics):
            dir_ = ball.position(physics) - walker.root_xpos(physics)
            n = np.linalg.norm(dir_[:2]) + 1e-7
            v = walker.root_linear_velocity(physics)
            return float(v[:2] @ (dir_[:2] / n))

        def stats_vel_to_ball(physics):
            return np.sum(_vel_to_ball(physics))

        def stats_closest_vel_to_ball(physics):
            closest, best = None, np.inf
            for p in task.players:
                if p.team != player.team:
                    continue
                d = np.linalg.norm(ball.position(physics)
                                   - p.walker.root_xpos(physics))
                if d < best:
                    best, closest = d, p
            return _vel_to_ball(physics) if closest is player else 0.0

        def stats_veloc_forward(physics):
            v = self._ego(player, physics,
                          walker.root_linear_velocity(physics))
            return float(v[0])

        def stats_vel_ball_to_goal(physics):
            goal = (task.arena.away_goal if player.team == Team.HOME
                    else task.arena.home_goal)
            direction = goal.mid - ball.position(physics)
            n = np.linalg.norm(direction)
            if n > 0:
                direction = direction / n
            return float(direction @ ball.linear_velocity(physics))

        def stats_avg_teammate_dist(physics):
            dists = [np.linalg.norm(walker.root_xpos(physics)
                                    - o.walker.root_xpos(physics))
                     for o in task.players
                     if o is not player and o.team == player.team]
            return float(np.mean(dists)) if dists else 0.0

        def stats_teammate_spread_out(physics):
            return float(stats_avg_teammate_dist(physics) > 5.0)

        def stats_home_score(physics):
            del physics
            scored = task.arena.detected_goal()
            return 1.0 if scored is not None and scored == player.team \
                else 0.0

        has_opponent = any(p.team != player.team for p in task.players)

        def stats_away_score(physics):
            del physics
            scored = task.arena.detected_goal()
            return (1.0 if has_opponent and scored is not None
                    and scored != player.team else 0.0)

        def stats_ball_events(physics):
            """[i_am_last_hit, hit, repossessed, intercepted]."""
            del physics
            return np.array([
                1.0 if ball.last_hit is player else 0.0,
                1.0 if ball.hit else 0.0,
                1.0 if ball.repossessed else 0.0,
                1.0 if ball.intercepted else 0.0,
            ])

        for name, fn in (
                ("stats_vel_to_ball", stats_vel_to_ball),
                ("stats_closest_vel_to_ball", stats_closest_vel_to_ball),
                ("stats_veloc_forward", stats_veloc_forward),
                ("stats_vel_ball_to_goal", stats_vel_ball_to_goal),
                ("stats_home_avg_teammate_dist", stats_avg_teammate_dist),
                ("stats_teammate_spread_out", stats_teammate_spread_out),
                ("stats_home_score", stats_home_score),
                ("stats_away_score", stats_away_score),
                ("stats_ball_events", stats_ball_events)):
            task.add_player_observable(player, name, Generic(fn))


class InterceptionObservablesAdder(ObservablesAdder):
    """Observables for ball reception/interception events at 5/10/15 m
    travel thresholds (reference observables.py:352-425)."""

    def __call__(self, task, player):
        ball = task.ball

        def stats_i_received_ball(physics):
            del physics
            return (1.0 if ball.hit and ball.repossessed
                    and ball.last_hit is player else 0.0)

        def stats_opponent_intercepted_ball(physics):
            del physics
            return (1.0 if ball.hit and ball.intercepted
                    and ball.last_hit is not None
                    and ball.last_hit.team != player.team else 0.0)

        task.add_player_observable(
            player, "stats_i_received_ball",
            Generic(stats_i_received_ball))
        task.add_player_observable(
            player, "stats_opponent_intercepted_ball",
            Generic(stats_opponent_intercepted_ball))

        for dist in (5, 10, 15):
            def received_dist(physics, dist=dist):
                return (1.0 if stats_i_received_ball(physics)
                        and ball.dist_between_last_hits is not None
                        and ball.dist_between_last_hits > dist else 0.0)

            def intercepted_dist(physics, dist=dist):
                return (1.0 if stats_opponent_intercepted_ball(physics)
                        and ball.dist_between_last_hits is not None
                        and ball.dist_between_last_hits > dist else 0.0)

            task.add_player_observable(
                player, f"stats_i_received_ball_{dist}m",
                Generic(received_dist))
            task.add_player_observable(
                player, f"stats_opponent_intercepted_ball_{dist}m",
                Generic(intercepted_dist))
