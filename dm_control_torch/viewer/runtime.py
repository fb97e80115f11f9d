"""Viewer runtime: paces an environment/policy loop at display cadence
(counterpart of ``dm_control_tpu/viewer/runtime.py``).

Behavioral contract shared with the reference viewer
(dm_control/viewer/runtime.py:75-232): a START → RUNNING → STOP →
STOPPED lifecycle with restart/pause, wall-clock-paced stepping against
simulation time, single-stepping while paused, default actions from the
action spec, and absorption of env/policy errors into listener
callbacks.

The implementation here is organized around two pieces this framework
needs that the reference does not: a ``FrameAllowance`` pacing clock
that is pure bookkeeping (so it can be unit-tested without an env and
reused by the headless Application), and state handlers that *return*
the successor state instead of mutating ``self._state`` mid-flight —
a single ``env.step`` on the card can take much longer than a display
frame, and keeping the transition logic pure makes the pacing math
auditable.
"""

from __future__ import annotations

import enum

import numpy as np

from dm_control_torch.viewer import util

#: Cap on simulation seconds granted per display frame: when the host
#: stalls (compile, GC) we refuse to "catch up" more than this much sim
#: time in one frame, so the picture never fast-forwards.
_MAX_SIM_SECONDS_PER_FRAME = 0.2


def _get_default_action(action_spec):
    """Action used when no policy is given: the midpoint of each bounded
    action dimension, zero for unbounded ones."""
    lo = np.broadcast_to(np.asarray(action_spec.minimum, float),
                         action_spec.shape)
    hi = np.broadcast_to(np.asarray(action_spec.maximum, float),
                         action_spec.shape)
    mid = np.where(np.isfinite(lo) & np.isfinite(hi), (lo + hi) / 2.0, 0.0)
    return mid.reshape(action_spec.shape)


class State(enum.Enum):
    START = 0
    RUNNING = 1
    STOP = 2
    STOPPED = 3
    RESTARTING = 4


class FrameAllowance:
    """Wall-clock → simulation-time pacing.

    Each display frame deposits the elapsed wall time (clipped to
    ``max_per_frame``) into an allowance account.  The simulation may
    only step while its own clock is below the account balance; a
    simulation that overshot (physics dt larger than the frame) simply
    skips frames until the balance catches up.
    """

    def __init__(self, max_per_frame: float = _MAX_SIM_SECONDS_PER_FRAME):
        self.max_per_frame = max_per_frame
        self._balance = 0.0

    def rebase(self, sim_time: float) -> None:
        """Aligns the account with the simulation clock (episode start)."""
        self._balance = sim_time

    def deposit(self, elapsed: float, sim_time: float):
        """Deposits one frame's worth of time.

        Returns the simulation time to advance to, or ``None`` when the
        simulation is still ahead of its allowance.
        """
        grant = min(elapsed, self.max_per_frame)
        sim_may_run = self._balance >= sim_time
        self._balance += grant
        return sim_time + grant if sim_may_run else None


class Runtime:
    """Steps an environment with a policy under viewer control."""

    def __init__(self, environment, policy=None):
        self.on_error = util.QuietSet()
        self.on_episode_begin = util.QuietSet()
        self.on_physics_changed = util.QuietSet()
        self._pacer = FrameAllowance()
        self._state = State.START
        self._simulation_timer = util.Timer()
        self._error_logger = util.ErrorLogger(self.on_error)
        self._env = environment
        self._policy = policy
        self._default_action = _get_default_action(environment.action_spec())
        self._time_step = None
        self._last_action = None

    @property
    def state(self):
        return self._state

    @property
    def last_action(self):
        return self._last_action

    @property
    def simulation_time(self):
        """Wall time spent inside the last tick."""
        return self._simulation_timer.measured_time

    @property
    def simulation_time_budget(self):
        return self._pacer.max_per_frame

    @simulation_time_budget.setter
    def simulation_time_budget(self, value):
        self._pacer.max_per_frame = value

    def get_time(self):
        return float(self._env.physics.time())

    # -- lifecycle commands --------------------------------------------------

    def tick(self, time_elapsed, paused):
        """Advances the lifecycle by one display frame.

        Handlers return the successor state; a finished episode falls
        all the way through to STOPPED within the same frame.
        """
        with self._simulation_timer.measure_time():
            state = self._state
            if state is State.RESTARTING:
                state = State.START
            if state is State.START:
                state = self._begin_episode()
            if state is State.RUNNING:
                state = self._run_frame(time_elapsed, paused)
            if state is State.STOP:
                state = State.STOPPED
            self._state = state

    def single_step(self):
        """One env step regardless of pacing (pause-mode stepping)."""
        if self._state is State.RUNNING:
            episode_over = self._act_once()
            self._state = State.STOP if episode_over else State.RUNNING

    def stop(self):
        self._state = State.STOPPED

    def restart(self):
        """Queues a fresh episode; takes effect on the next tick."""
        if self._state is State.STOPPED:
            self._state = State.START
        else:
            self._state = State.RESTARTING

    # -- state handlers (each returns the successor state) -------------------

    def _begin_episode(self) -> State:
        before = self._live_data()
        with self._error_logger:
            self._time_step = self._env.reset()
        if self._live_data() is not before:
            for listener in self.on_physics_changed:
                listener()
        if self._error_logger.errors_found:
            return State.STOPPED
        for listener in self.on_episode_begin:
            listener()
        self._pacer.rebase(self.get_time())
        return State.RUNNING

    def _live_data(self):
        """The Data the env's physics holds (None before its first reset):
        a reset that replaces it notifies ``on_physics_changed``."""
        return getattr(self._env.physics, "_data", None)

    def _run_frame(self, time_elapsed, paused) -> State:
        if paused:
            # keep derived quantities fresh where the physics facade
            # supports it (a batched-state view may not expose forward)
            refresh = getattr(self._env.physics, "forward", None)
            if refresh is not None:
                refresh()
            return State.RUNNING
        target = self._pacer.deposit(time_elapsed, self.get_time())
        while target is not None and self.get_time() < target:
            if self._act_once():
                return State.STOP
        return State.RUNNING

    def _act_once(self) -> bool:
        """Queries the policy and steps the env once; True = episode over
        (naturally or through an absorbed error)."""
        with self._error_logger:
            if self._policy is None:
                action = self._default_action
            else:
                action = self._policy(self._time_step)
            self._last_action = action
            self._time_step = self._env.step(action)
            if not self._time_step.last():
                return self._error_logger.errors_found
        return True

