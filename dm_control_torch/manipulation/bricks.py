"""Brick stacking / reassembly tasks (counterpart of
``dm_control_tpu/manipulation/bricks.py``; reference:
dm_control/manipulation/bricks.py:200-690).

Uses the stud-coupling Duplo prop (entities/props/duplo): bricks snap
together via geometric stud/tube interference, and the stacking reward
measures the stud-to-hole engagement of each consecutive pair in the
target order (the reference's `_StackReward` closeness measure).  They
run on composer's host path only (``manipulation.load``), as in the JAX
package: ``load_batch`` refuses them.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.entities.props.duplo import BRICK_HEIGHT, Duplo
from dm_control_torch.manipulation.shared import registry
from dm_control_torch.manipulation.shared import observations as obs_mod
from dm_control_torch.manipulation.shared import workspaces
from dm_control_torch.manipulation.shared.task import ArmTask
from dm_control_torch.utils import rewards

#: a stud is "engaged" when it sits within this distance of its hole
_ALIGN_RADIUS = 0.005

#: minimum XY center separation between spawned bricks — the 2x4 brick's
#: half-diagonal is ~36 mm, so 80 mm guarantees disjoint footprints
_MIN_SEPARATION = 0.08

_PROP_BOX = workspaces.BoundingBox(
    lower=(-0.2, -0.1, 0.0), upper=(0.2, 0.15, 0.0))

_COLORS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1))


class Stack(ArmTask):
    """Stack ``n_target`` of ``n_bricks`` bricks in a target order
    (reference bricks.py:260 `_Stack`)."""

    time_limit = 20.0

    def __init__(self, n_bricks=2, n_target=None, randomize_order=False,
                 moveable_base=True, reassemble=False, obs_settings=None):
        super().__init__(obs_settings=obs_settings)
        self._n_bricks = n_bricks
        self._n_target = n_target if n_target is not None else n_bricks
        self._randomize_order = randomize_order
        self._moveable_base = moveable_base
        self._reassemble = reassemble
        self._bricks = []
        for i in range(n_bricks):
            brick = Duplo(color=_COLORS[i], name=f"brick_{i}")
            if i == 0 and not moveable_base:
                # fixed base brick welded to the arena
                # (reference bricks.py:596 fixed-base variants)
                frame = self._arena.attach(brick)
                frame.attrib["pos"] = "0.1 0.1 0"
            else:
                self._add_free_prop(brick)
            if self._obs_settings.prop_pose.enabled:
                brick.observables.enable_all()
            self._bricks.append(brick)
        self._order = list(range(self._n_target))

    def initialize_episode(self, physics, random_state):
        super().initialize_episode(physics, random_state)
        if self._randomize_order:
            self._order = list(random_state.permutation(
                self._n_bricks)[:self._n_target])
        else:
            self._order = list(range(self._n_target))
        free = [b for i, b in enumerate(self._bricks)
                if not (i == 0 and not self._moveable_base)]
        if self._reassemble:
            # start pre-stacked (studs engaged) in index order; the
            # target order differs
            base = np.array([0.0, 0.1, 0.0])
            for k, brick in enumerate(free):
                brick.set_pose(
                    physics,
                    position=base + [0, 0, BRICK_HEIGHT * k],
                    quaternion=(1, 0, 0, 0))
            if not self._randomize_order:
                # fixed reassembly order: reversed initial order
                self._order = list(reversed(self._order))
        else:
            # rejection-resample so no free brick spawns interpenetrating
            # another brick or the welded base at (0.1, 0.1) — with the
            # stiff snap-contact model an overlapping spawn injects large
            # forces at episode start (the reference settles via
            # PropPlacer; here spawn positions are simply kept disjoint)
            placed = ([] if self._moveable_base
                      else [np.array([0.1, 0.1, 0.0])])
            for brick in free:
                for _attempt in range(100):
                    pos = workspaces.uniform_in_box(_PROP_BOX, random_state)
                    pos[2] = 0.0
                    if all(np.linalg.norm(pos[:2] - p[:2]) > _MIN_SEPARATION
                           for p in placed):
                        break
                placed.append(pos)
                brick.set_pose(physics, position=pos,
                               quaternion=(1, 0, 0, 0))

    def _brick_position(self, physics, index):
        pos, _quat = self._bricks[index].get_pose(physics)
        return np.asarray(pos)

    def get_reward(self, physics):
        # stud/hole engagement of each consecutive (bottom, top) pair in
        # the target order: when snapped, the top brick's origin sits one
        # brick height above the bottom brick's
        pair_rewards = []
        for bottom_i, top_i in zip(self._order[:-1], self._order[1:]):
            bottom = self._brick_position(physics, bottom_i)
            top = self._brick_position(physics, top_i)
            target = bottom + np.array([0.0, 0.0, BRICK_HEIGHT])
            dist = float(np.linalg.norm(top - target))
            pair_rewards.append(rewards.tolerance(
                dist, bounds=(0, _ALIGN_RADIUS), margin=0.05))
        stack = float(np.mean(pair_rewards)) if pair_rewards else 0.0
        top_brick = self._brick_position(physics, self._order[-1])
        reach_dist = float(np.linalg.norm(
            self._pinch_position(physics) - top_brick))
        reach = rewards.tolerance(reach_dist, bounds=(0, 0.05), margin=0.4)
        return 0.9 * stack + 0.1 * reach


def _make(obs_settings, **kwargs):
    return Stack(obs_settings=obs_settings, **kwargs)


@registry.add(registry.tags.FEATURES)
def stack_2_bricks_features():
    return _make(obs_mod.PERFECT_FEATURES, n_bricks=2, moveable_base=False)


@registry.add(registry.tags.VISION)
def stack_2_bricks_vision():
    return _make(obs_mod.VISION, n_bricks=2, moveable_base=False)


@registry.add(registry.tags.FEATURES)
def stack_2_bricks_moveable_base_features():
    return _make(obs_mod.PERFECT_FEATURES, n_bricks=2, moveable_base=True)


@registry.add(registry.tags.VISION)
def stack_2_bricks_moveable_base_vision():
    return _make(obs_mod.VISION, n_bricks=2, moveable_base=True)


@registry.add(registry.tags.FEATURES)
def stack_3_bricks_features():
    return _make(obs_mod.PERFECT_FEATURES, n_bricks=3, moveable_base=False)


@registry.add(registry.tags.VISION)
def stack_3_bricks_vision():
    return _make(obs_mod.VISION, n_bricks=3, moveable_base=False)


@registry.add(registry.tags.FEATURES)
def stack_3_bricks_random_order_features():
    return _make(obs_mod.PERFECT_FEATURES, n_bricks=3,
                 randomize_order=True, moveable_base=False)


@registry.add(registry.tags.FEATURES)
def stack_2_of_3_bricks_random_order_features():
    return _make(obs_mod.PERFECT_FEATURES, n_bricks=3, n_target=2,
                 randomize_order=True, moveable_base=True)


@registry.add(registry.tags.VISION)
def stack_2_of_3_bricks_random_order_vision():
    return _make(obs_mod.VISION, n_bricks=3, n_target=2,
                 randomize_order=True, moveable_base=True)


@registry.add(registry.tags.FEATURES)
def reassemble_3_bricks_fixed_order_features():
    return _make(obs_mod.PERFECT_FEATURES, n_bricks=3, reassemble=True,
                 moveable_base=True)


@registry.add(registry.tags.VISION)
def reassemble_3_bricks_fixed_order_vision():
    return _make(obs_mod.VISION, n_bricks=3, reassemble=True,
                 moveable_base=True)


@registry.add(registry.tags.FEATURES)
def reassemble_5_bricks_random_order_features():
    return _make(obs_mod.PERFECT_FEATURES, n_bricks=5, reassemble=True,
                 randomize_order=True, moveable_base=True)


@registry.add(registry.tags.VISION)
def reassemble_5_bricks_random_order_vision():
    return _make(obs_mod.VISION, n_bricks=5, reassemble=True,
                 randomize_order=True, moveable_base=True)
