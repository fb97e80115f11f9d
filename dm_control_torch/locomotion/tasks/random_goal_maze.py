"""Goal-directed maze task family.

Reference: dm_control/locomotion/tasks/random_goal_maze.py:36-478 —
NullGoalMaze (spawn/aliveness/contact-termination base),
RepeatSingleGoalMaze (re-randomized target, reward per activation),
ManyHeterogeneousGoalsMaze / ManyGoalsMaze (mixed target types with
per-type rewards), RepeatSingleGoalMazeAugmentedWithTargets (a main
target plus low-reward subtargets).  Egocentric-camera observables are
rendering-path and omitted; proprioception/kinematic groups are enabled.

Counterpart of ``dm_control_tpu/locomotion/tasks/random_goal_maze.py``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic

DEFAULT_CONTROL_TIMESTEP = 0.025
DEFAULT_PHYSICS_TIMESTEP = 0.005
DEFAULT_ALIVE_THRESHOLD = -0.5


class NullGoalMaze(composer.Task):
    """Base maze navigation task (reference random_goal_maze.py:36)."""

    def __init__(self, walker, maze_arena,
                 randomize_spawn_position=True,
                 randomize_spawn_rotation=True,
                 aliveness_reward=0.0,
                 aliveness_threshold=DEFAULT_ALIVE_THRESHOLD,
                 contact_termination=True,
                 enable_global_task_observables=False,
                 physics_timestep=DEFAULT_PHYSICS_TIMESTEP,
                 control_timestep=DEFAULT_CONTROL_TIMESTEP):
        self._walker = walker
        self._maze_arena = maze_arena
        maze_arena.add_free_entity(walker)
        self._randomize_spawn_position = randomize_spawn_position
        self._randomize_spawn_rotation = randomize_spawn_rotation
        self._aliveness_reward = aliveness_reward
        self._aliveness_threshold = aliveness_threshold
        self._contact_termination = contact_termination
        self._discount = 1.0
        self.set_timesteps(control_timestep, physics_timestep)
        if hasattr(walker.observables, "enable_proprioception"):
            walker.observables.enable_proprioception()
        self._task_observables = {}
        if enable_global_task_observables:
            self._task_observables["maze_layout"] = Generic(
                lambda _: np.array(
                    [[ord(c) for c in row] for row in
                     self._maze_arena.maze.entity_layer.splitlines()],
                    np.int32))
            self._task_observables["absolute_position"] = Generic(
                lambda p: np.asarray(self._walker.root_xpos(p)))
            self._task_observables["absolute_orientation"] = Generic(
                lambda p: np.asarray(self._walker.root_xmat(p)))
            for obs in self._task_observables.values():
                obs.enabled = True

    @property
    def root_entity(self):
        return self._maze_arena

    @property
    def task_observables(self):
        return self._task_observables

    @property
    def name(self):
        return "goal_maze"

    def _respawn(self, physics, random_state):
        spawns = self._maze_arena.spawn_positions
        if self._randomize_spawn_position and spawns:
            pos = spawns[random_state.randint(len(spawns))]
        elif spawns:
            pos = spawns[0]
        else:
            pos = np.zeros(3)
        pos = np.asarray(pos, float).copy()
        pos[2] += 0.5
        quat = (1.0, 0.0, 0.0, 0.0)
        if self._randomize_spawn_rotation:
            yaw = random_state.uniform(0, 2 * np.pi)
            quat = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
        self._walker.set_pose(physics, position=pos, quaternion=quat)

    def initialize_episode(self, physics, random_state):
        self._respawn(physics, random_state)
        self._discount = 1.0
        self._failure_termination = False

    def _walker_nonfoot_ground_contact(self, physics):
        """True if a non-foot walker geom touches an arena ground geom
        (reference _is_disallowed_contact, random_goal_maze.py:216)."""
        m = physics.model
        d = physics.data
        walker_prefix = self._walker.name + "/"
        ground_ids = set()
        walker_nonfoot = set()
        for name, gid in m.names.geom.items():
            if name.startswith(walker_prefix):
                if "foot" not in name and "toe" not in name:
                    walker_nonfoot.add(gid)
            elif name.startswith(("floor", "wall", "ground")):
                ground_ids.add(gid)
        if not ground_ids or not walker_nonfoot:
            return False
        dist = d.contact.dist.cpu().numpy()  # one copy from the device
        g1 = np.asarray(d.contact.geom1)
        g2 = np.asarray(d.contact.geom2)
        for k in np.where(dist < 0)[0]:
            a, b = int(g1[k]), int(g2[k])
            if ((a in ground_ids and b in walker_nonfoot)
                    or (b in ground_ids and a in walker_nonfoot)):
                return True
        return False

    def after_step(self, physics, random_state):
        self._failure_termination = False
        if self._contact_termination:
            self._failure_termination = \
                self._walker_nonfoot_ground_contact(physics)
        if hasattr(self._walker, "aliveness"):
            if self._walker.aliveness(physics) < self._aliveness_threshold:
                self._failure_termination = True

    def should_terminate_episode(self, physics):
        if self._failure_termination:
            self._discount = 0.0
            return True
        return False

    def get_discount(self, physics):
        return self._discount

    def get_reward(self, physics):
        del physics
        return self._aliveness_reward


class RepeatSingleGoalMaze(NullGoalMaze):
    """Reach one target; it re-randomizes on activation
    (reference random_goal_maze.py:247)."""

    def __init__(self, walker, maze_arena, target=None,
                 target_reward_scale=1.0,
                 max_repeats=0, **kwargs):
        super().__init__(walker, maze_arena, **kwargs)
        if target is None:
            from dm_control_torch.locomotion.props.target_sphere import (
                TargetSphere,
            )

            target = TargetSphere(radius=0.4, name="target")
        self._target = target
        self._maze_arena.attach(target)
        self._target_reward_scale = target_reward_scale
        self._max_repeats = max_repeats
        self._rewarded_this_step = False
        self._targets_obtained = 0
        self._task_observables["target_position"] = Generic(
            lambda p: np.asarray(self._target_pos(p)))
        self._task_observables["target_position"].enabled = True

    def _target_pos(self, physics):
        return physics.bind(self._target.attachment_frame).xpos

    def initialize_episode(self, physics, random_state):
        super().initialize_episode(physics, random_state)
        self._place_target(physics, random_state)
        self._target.reset(physics)
        self._rewarded_this_step = False
        self._targets_obtained = 0

    def _place_target(self, physics, random_state):
        targets = self._maze_arena.target_positions
        if targets:
            pos = targets[random_state.randint(len(targets))]
        else:
            pos = np.zeros(3)
        pos = np.asarray(pos, float).copy()
        pos[2] += self._target.radius
        binding = physics.bind(self._target.attachment_frame)
        binding.pos = pos

    def after_step(self, physics, random_state):
        super().after_step(physics, random_state)
        self._rewarded_this_step = False
        walker_pos = self._walker.root_xpos(physics)
        if self._target.maybe_activate(physics, walker_pos):
            self._rewarded_this_step = True
            self._targets_obtained += 1
            if self._targets_obtained <= self._max_repeats:
                self._place_target(physics, random_state)
                self._target.reset(physics)

    def should_terminate_episode(self, physics):
        if super().should_terminate_episode(physics):
            return True
        return self._targets_obtained > self._max_repeats

    def get_reward(self, physics):
        r = self._aliveness_reward
        if self._rewarded_this_step:
            r += self._target_reward_scale
        return r


class ManyHeterogeneousGoalsMaze(NullGoalMaze):
    """Collect targets of several types with per-type rewards
    (reference random_goal_maze.py:340)."""

    def __init__(self, walker, maze_arena,
                 target_builders: Sequence[Callable],
                 target_type_rewards: Sequence[float],
                 target_type_proportions: Sequence[float],
                 shuffle_target_builders=False, **kwargs):
        super().__init__(walker, maze_arena, **kwargs)
        self._target_builders = list(target_builders)
        self._target_type_rewards = tuple(target_type_rewards)
        self._target_type_proportions = tuple(target_type_proportions)
        self._shuffle = shuffle_target_builders
        n_slots = max(1, len(maze_arena.target_positions))
        self._targets = []
        self._target_types = []
        counts = self._type_counts(n_slots)
        idx = 0
        for ttype, count in enumerate(counts):
            for _ in range(count):
                t = self._target_builders[ttype](name=f"target_{idx}")
                self._maze_arena.attach(t)
                self._targets.append(t)
                self._target_types.append(ttype)
                idx += 1

    def _type_counts(self, total):
        props = np.asarray(self._target_type_proportions, float)
        frac = props / props.sum()
        counts = np.floor(frac * total).astype(int)
        # hand out remainders to the types furthest below their ideal
        while counts.sum() < total:
            deficit = frac * total - counts
            counts[int(np.argmax(deficit))] += 1
        return counts

    def initialize_episode(self, physics, random_state):
        super().initialize_episode(physics, random_state)
        slots = list(self._maze_arena.target_positions)
        order = random_state.permutation(len(slots)) if slots else []
        for i, target in enumerate(self._targets):
            if len(slots):
                pos = np.asarray(slots[order[i % len(slots)]], float).copy()
            else:
                pos = np.zeros(3)
            pos[2] += target.radius
            physics.bind(target.attachment_frame).pos = pos
            target.reset(physics)
        self._obtained = [False] * len(self._targets)

    def after_step(self, physics, random_state):
        super().after_step(physics, random_state)
        walker_pos = self._walker.root_xpos(physics)
        self._step_reward = 0.0
        for i, target in enumerate(self._targets):
            if not self._obtained[i] and target.maybe_activate(
                    physics, walker_pos):
                self._obtained[i] = True
                self._step_reward += \
                    self._target_type_rewards[self._target_types[i]]

    def get_reward(self, physics):
        return self._aliveness_reward + getattr(self, "_step_reward", 0.0)

    def should_terminate_episode(self, physics):
        if super().should_terminate_episode(physics):
            return True
        return all(getattr(self, "_obtained", [False]))


class ManyGoalsMaze(ManyHeterogeneousGoalsMaze):
    """All targets share one type (reference random_goal_maze.py:446)."""

    def __init__(self, walker, maze_arena, target_builder,
                 target_reward_scale=1.0, **kwargs):
        super().__init__(walker, maze_arena,
                         target_builders=[target_builder],
                         target_type_rewards=[target_reward_scale],
                         target_type_proportions=[1], **kwargs)


class RepeatSingleGoalMazeAugmentedWithTargets(RepeatSingleGoalMaze):
    """Main target plus low-reward subtargets
    (reference random_goal_maze.py:478)."""

    def __init__(self, walker, main_target, maze_arena,
                 num_subtargets=20,
                 target_reward_scale=10.0,
                 subtarget_reward_scale=1.0, **kwargs):
        super().__init__(walker, maze_arena, target=main_target,
                         target_reward_scale=target_reward_scale, **kwargs)
        from dm_control_torch.locomotion.props.target_sphere import (
            TargetSphere,
        )

        self._subtarget_reward_scale = subtarget_reward_scale
        self._subtargets = []
        for i in range(num_subtargets):
            t = TargetSphere(radius=0.3, name=f"subtarget_{i}")
            self._maze_arena.attach(t)
            self._subtargets.append(t)

    def initialize_episode(self, physics, random_state):
        super().initialize_episode(physics, random_state)
        slots = list(self._maze_arena.target_positions) \
            + list(self._maze_arena.spawn_positions)
        for i, t in enumerate(self._subtargets):
            if slots:
                pos = np.asarray(slots[i % len(slots)], float).copy()
                jitter = random_state.uniform(-0.5, 0.5, 2)
                pos[:2] += jitter
            else:
                pos = np.zeros(3)
            pos[2] += t.radius
            physics.bind(t.attachment_frame).pos = pos
            t.reset(physics)
        self._sub_obtained = [False] * len(self._subtargets)

    def after_step(self, physics, random_state):
        super().after_step(physics, random_state)
        walker_pos = self._walker.root_xpos(physics)
        self._sub_reward = 0.0
        for i, t in enumerate(self._subtargets):
            if not self._sub_obtained[i] and t.maybe_activate(
                    physics, walker_pos):
                self._sub_obtained[i] = True
                self._sub_reward += self._subtarget_reward_scale

    def get_reward(self, physics):
        return (super().get_reward(physics)
                + getattr(self, "_sub_reward", 0.0))
