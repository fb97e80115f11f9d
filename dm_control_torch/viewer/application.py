"""Viewer application: drives the Runtime at a frame cadence over a
pluggable renderer (counterpart of ``dm_control_tpu/viewer/application.py``).

Reference: dm_control/viewer/application.py:188-320 — the GLFW window,
render loop `_tick`, pause/speed/step controls.  GL is off-path here; the
default renderer is the ray-cast raster (dm_control_torch.rendering) and a
GUI backend can be plugged in through ``frame_callback`` (e.g. to pipe
frames into notebooks or video writers).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from dm_control_torch.viewer import runtime as runtime_module
from dm_control_torch.viewer import util


class Application:
    """Headless viewer application loop."""

    def __init__(self, title="Explorer", width=320, height=240,
                 fps=30.0):
        self._title = title
        self._width = width
        self._height = height
        self._fps = fps
        self._runtime: Optional[runtime_module.Runtime] = None
        self._pause = False
        self._time_multiplier = util.TimeMultiplier(1.0)
        self._frame_callback: Optional[Callable] = None
        self._render_enabled = False

    # -- controls (reference application.py key bindings) -------------------

    def toggle_pause(self):
        self._pause = not self._pause

    def speed_up(self):
        self._time_multiplier.increase()

    def slow_down(self):
        self._time_multiplier.decrease()

    def single_step(self):
        if self._runtime:
            self._runtime.single_step()

    def restart(self):
        if self._runtime:
            self._runtime.restart()

    def set_frame_callback(self, fn, render=True):
        """fn(frame_or_none, runtime) called once per display tick."""
        self._frame_callback = fn
        self._render_enabled = render

    # -- main loop -----------------------------------------------------------

    def launch(self, environment_loader, policy=None, max_episodes=1,
               max_seconds=None, realtime=False):
        """Runs episodes through the Runtime state machine.

        Headless: ticks the runtime at the display cadence; when a frame
        callback is set (and render enabled), each tick also ray-casts an
        RGB frame from the physics."""
        env = (environment_loader() if callable(environment_loader)
               else environment_loader)
        episodes = 0
        t_start = time.perf_counter()
        frame_dt = 1.0 / self._fps
        stats = []
        while episodes < max_episodes:
            self._runtime = runtime_module.Runtime(env, policy)
            ret, steps = 0.0, 0

            def count(ts_ret=None):
                pass

            while self._runtime.state != runtime_module.State.STOPPED:
                elapsed = (frame_dt if not realtime
                           else frame_dt) * self._time_multiplier.get()
                self._runtime.tick(elapsed, self._pause)
                if self._runtime._time_step is not None:
                    r = self._runtime._time_step.reward
                    if r is not None:
                        ret += float(r)
                        steps += 1
                if self._frame_callback is not None:
                    frame = None
                    if self._render_enabled:
                        frame = env.physics.render(
                            height=self._height, width=self._width)
                    self._frame_callback(frame, self._runtime)
                if realtime:
                    time.sleep(frame_dt)
                if (max_seconds is not None
                        and time.perf_counter() - t_start > max_seconds):
                    self._runtime.stop()
            stats.append((steps, ret))
            print(f"[viewer] episode {episodes}: ~{steps} frames, "
                  f"return {ret:.3f}")
            episodes += 1
        return stats
