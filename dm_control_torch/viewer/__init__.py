"""Interactive viewer (counterpart of ``dm_control_tpu/viewer/``;
reference: dm_control/viewer/).

``launch(environment_loader, policy)`` drives the reference's
Runtime state machine (START→RUNNING→STOP→STOPPED with restart/pause/
single-step, runtime.py:75) through a headless Application whose frames
come from the ray-cast renderer on the physics' device — there is no GL
context.  A GUI backend can still be registered to take over the whole
loop.
"""

from __future__ import annotations

from dm_control_torch.viewer.application import Application  # noqa: F401
from dm_control_torch.viewer.runtime import Runtime, State  # noqa: F401
from dm_control_torch.viewer.util import (  # noqa: F401
    Integrator, TimeMultiplier,
)


def launch_web(environment_loader, policy=None, **kwargs):
    """Interactive browser viewer (stdlib HTTP + canvas; web_gui.py):
    orbit/pan/zoom camera, click-to-select, drag perturbation,
    pause/step/restart."""
    from dm_control_torch.viewer import web_gui

    return web_gui.launch(environment_loader, policy, **kwargs)

_BACKEND = None


def register_backend(fn):
    """Registers fn(env, policy) used by launch() for interactive GUI."""
    global _BACKEND
    _BACKEND = fn


def launch(environment_loader, policy=None, title="Explorer",
           width=1024, height=768, max_episodes=1, max_seconds=None):
    """Launches the viewer loop (reference viewer/__init__.py:22)."""
    env = (environment_loader() if callable(environment_loader)
           else environment_loader)
    if _BACKEND is not None:
        return _BACKEND(env, policy)
    app = Application(title=title, width=width, height=height)
    return app.launch(env, policy=policy, max_episodes=max_episodes,
                      max_seconds=max_seconds)
