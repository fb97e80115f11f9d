"""The port's interactive viewer: the seven cases of
``tests/test_viewer_interactive.py`` on ``dm_control_torch.viewer``, the
headless application, ``launch`` and the four explore scripts.

InputMap bindings, the free camera's orbit, pan and zoom, the camera
selector, click-to-select by a segmentation lookup and a perturbation
written into the live state's ``xfrc_applied`` on the state's own device
(a ``cuda`` case on the card), and the web GUI end to end over localhost
HTTP, urllib playing the browser.  The file imports no JAX, so its
``cuda`` case runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_viewer.py -q
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from dm_control_torch import composer as tcomposer
from dm_control_torch import suite, viewer
from dm_control_torch.rendering.camera import MovableCamera, Pose
from dm_control_torch.viewer import user_input
from dm_control_torch.viewer.viewer import (
    CameraSelector, FreeCameraController, Viewer, apply_perturbation,
)


class _FakeCamera:
    """Pose-only stand-in for rendering.MovableCamera."""

    def __init__(self):
        self._pose = Pose(lookat=np.zeros(3), distance=2.0, azimuth=90.0,
                          elevation=-45.0)

    def get_pose(self):
        return self._pose

    def set_pose(self, lookat, distance, azimuth, elevation):
        self._pose = Pose(np.asarray(lookat, float), float(distance),
                          float(azimuth), float(elevation))


# -- InputMap ---------------------------------------------------------------


def test_input_map_plain_and_range():
    im = user_input.InputMap()
    fired = []
    im.bind(lambda: fired.append("a"), "a")
    im.bind(fired.append, user_input.Range(["1", "2", "3"]))
    im.key_event("a", True)
    im.key_event("2", True)
    im.key_event("2", False)  # releases don't fire plain bindings
    assert fired == ["a", 1]


def test_input_map_exclusive_suppresses_others():
    im = user_input.InputMap()
    log = []
    im.bind(lambda e: log.append(("excl", e)),
            user_input.Exclusive(user_input.MOUSE_LEFT))
    im.bind(lambda: log.append("plain"), "p")
    im.key_event(user_input.MOUSE_LEFT, True)
    im.key_event("p", True)  # suppressed while exclusive held
    im.key_event(user_input.MOUSE_LEFT, False)
    im.key_event("p", True)
    assert log == [("excl", True), ("excl", False), "plain"]


def test_input_map_modifiers_and_double_click():
    im = user_input.InputMap()
    log = []
    im.bind(lambda e: log.append(("shift", e)),
            user_input.Exclusive((user_input.MOD_SHIFT,
                                  user_input.MOUSE_RIGHT)))
    im.bind(lambda: log.append("dbl"),
            user_input.DoubleClick(user_input.MOUSE_LEFT))
    im.key_event(user_input.MOUSE_RIGHT, True)  # no modifier: nothing
    im.key_event(user_input.MOUSE_RIGHT, False)
    im.key_event(user_input.MOUSE_RIGHT, True, user_input.MOD_SHIFT)
    im.key_event(user_input.MOUSE_RIGHT, False, user_input.MOD_SHIFT)
    im.double_click(user_input.MOUSE_LEFT)
    assert log == [("shift", True), ("shift", False), "dbl"]


# -- camera controller --------------------------------------------------------


def test_free_camera_orbit_pan_zoom():
    cam = _FakeCamera()
    ctl = FreeCameraController(cam)
    ctl.set_rotate_mode(True)
    ctl.on_move((0, 0), (10.0, -5.0))
    ctl.set_rotate_mode(False)
    pose = cam.get_pose()
    assert pose.azimuth == pytest.approx(90.0 - 0.4 * 10)
    assert pose.elevation == pytest.approx(-45.0 + 0.4 * 5)

    ctl.set_pan_horizontal_mode(True)
    before = cam.get_pose().lookat.copy()
    ctl.on_move((0, 0), (100.0, 0.0))
    ctl.set_pan_horizontal_mode(False)
    assert np.linalg.norm(cam.get_pose().lookat - before) > 0

    d0 = cam.get_pose().distance
    ctl.zoom(2.0)
    assert cam.get_pose().distance == pytest.approx(d0 * 0.9)

    # elevation clamps at +-89
    cam.set_pose(np.zeros(3), 1.0, 0.0, 88.0)
    ctl.set_rotate_mode(True)
    ctl.on_move((0, 0), (0.0, -100.0))
    assert cam.get_pose().elevation == 89.0


def test_camera_selector_cycles():
    sel = CameraSelector(2)
    assert sel.is_free
    sel.select_next()
    assert sel.camera_id == 0
    sel.select_next()
    assert sel.camera_id == 1
    sel.select_next()
    assert sel.is_free
    sel.select_previous()
    assert sel.camera_id == 1


# -- selection + perturbation over a live env ---------------------------------


def _select_and_perturb(env):
    """Clicks the view's centre and drags: the body the segmentation names
    is selected and its perturbation lands in the live state's
    ``xfrc_applied``; returns (body, the state's xfrc_applied)."""
    cam = MovableCamera(env.physics, height=64, width=64)
    view = Viewer(cam, env.physics,
                  n_fixed_cameras=int(env.physics.model.ncam))
    body = view.select_at((32, 32))
    seg = cam.render(segmentation=True)
    assert body == env.physics.model.geom_bodyid[seg[32, 32, 0]]
    view.manipulator.set_move_horizontal_mode(True)
    view.manipulator.on_move((32, 32), (20.0, 0.0))
    bid, force = view.manipulator.perturbation_force
    assert bid == body and force[0] == pytest.approx(20.0 * 0.2)
    assert apply_perturbation(env, bid, force)
    return body, env.physics.data.xfrc_applied


@pytest.fixture(scope="module")
def cartpole_env():
    env = suite.load("cartpole", "swingup", task_kwargs={"random": 3},
                     device="cpu")
    env.reset()
    return env


def test_select_and_perturb(cartpole_env):
    env = cartpole_env
    body, xfrc = _select_and_perturb(env)
    assert xfrc.device.type == "cpu" and xfrc.dtype == torch.float64
    assert xfrc[body, 0] == 4.0 and int((xfrc != 0).sum()) == 1
    # the perturbed env still steps, and the force moved it
    twin = suite.load("cartpole", "swingup", task_kwargs={"random": 3},
                      device="cpu")
    twin.reset()
    ts, ts_twin = (e.step(np.zeros(1)) for e in (env, twin))
    assert np.isfinite(ts.reward)
    assert not np.array_equal(ts.observation["velocity"],
                              ts_twin.observation["velocity"])
    # the composer environment's state lives in its Physics
    task = _DropTask()
    cenv = tcomposer.Environment(task, time_limit=1.0, device="cpu")
    assert not apply_perturbation(suite.load(
        "cartpole", "swingup", device="cpu"), 1, np.ones(6))  # not reset
    cenv.reset()
    assert apply_perturbation(cenv, 1, np.arange(6.0))
    assert cenv.physics.data.xfrc_applied[1].tolist() == list(range(6))


class _DropTask(tcomposer.Task):
    """A ball over a floor (a composer task for the perturbation)."""

    def __init__(self):
        from dm_control_torch.composer.arena import Arena

        self._arena = Arena()
        wb = self._arena.mjcf_model.first("worldbody")
        wb.add("geom", type="plane", size="2 2 .1")
        ball = wb.add("body", name="ball", pos="0 0 1")
        ball.add("freejoint")
        ball.add("geom", type="sphere", size=".1")

    @property
    def root_entity(self):
        return self._arena

    def get_reward(self, physics):
        return 0.0


@pytest.mark.cuda
def test_perturbation_lands_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the physics runs on the card")
    env = suite.load("cartpole", "swingup", task_kwargs={"random": 3},
                     device="cuda")
    env.reset()
    body, xfrc = _select_and_perturb(env)
    assert xfrc.device.type == "cuda"
    assert float(xfrc[body, 0]) == 4.0
    assert np.isfinite(env.step(np.zeros(1)).reward)


def test_web_gui_end_to_end(cartpole_env):
    from dm_control_torch.viewer.web_gui import WebViewerServer

    server = WebViewerServer(cartpole_env, width=64, height=48, port=0)
    thread = threading.Thread(target=server.httpd.serve_forever,
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"viewer" in page
        # run a few display ticks, then fetch a frame
        for _ in range(3):
            server.tick(0.04)
        frame = urllib.request.urlopen(base + "/frame", timeout=10).read()
        assert frame[:8] == b"\x89PNG\r\n\x1a\n"
        # orbit the camera through the event endpoint
        az0 = server.camera.get_pose().azimuth
        for ev in [
            {"type": "key", "key": "MouseLeft", "pressed": True,
             "mods": 0},
            {"type": "move", "pos": [10, 10], "delta": [15, 0]},
            {"type": "key", "key": "MouseLeft", "pressed": False,
             "mods": 0},
            {"type": "key", "key": " ", "pressed": True, "mods": 0},
        ]:
            urllib.request.urlopen(urllib.request.Request(
                base + "/event", data=json.dumps(ev).encode(),
                method="POST"), timeout=10).read()
        assert server.camera.get_pose().azimuth != az0
        assert server.paused  # space toggled pause
        status = json.loads(urllib.request.urlopen(
            base + "/status", timeout=10).read())
        assert status["paused"] is True
        assert status["state"] in ("START", "RUNNING", "STOP", "STOPPED")
        assert "fps" in status and "camera" in status  # status pane rows
        # help pane rows (reference views.py HelpPane)
        rows = json.loads(urllib.request.urlopen(
            base + "/help", timeout=10).read())
        assert any("pause" in desc for _k, desc in rows)
        assert any("orbit" in desc for _k, desc in rows)
        # frame capture: PNG with download semantics
        req = urllib.request.urlopen(base + "/capture", timeout=10)
        assert req.headers["Content-Disposition"].startswith("attachment")
        assert req.read()[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# -- the application, launch and the explore scripts --------------------------


def test_application_frames_and_launch():
    env = suite.load("cartpole", "swingup", task_kwargs={"random": 3,
                                                          "time_limit": 0.1},
                     device="cpu")
    app = viewer.Application(width=32, height=24)
    frames = []
    app.set_frame_callback(lambda frame, runtime: frames.append(frame))
    stats = app.launch(env, max_episodes=1)
    assert len(stats) == 1 and stats[0][0] > 0 and len(frames) > 1
    assert frames[-1].shape == (24, 32, 3) and frames[-1].dtype == np.uint8
    seen = []
    viewer.register_backend(lambda e, policy: seen.append(e) or "backend")
    try:
        assert viewer.launch(lambda: env) == "backend" and seen == [env]
    finally:
        viewer.register_backend(None)


@pytest.mark.parametrize("script,argv", [
    ("suite", ["--environment_name=cartpole.balance", "--action_noise=0.1",
               "--no-timeout"]),
    ("manipulation", ["--environment_name=reach_site_features"]),
    ("soccer", ["--team_size=1", "--walker_type=ANT",
                "--no-terminate_on_goal"]),
    ("examples", ["--environment=cmu_humanoid_go_to_target"]),
])
def test_explore_scripts(script, argv, monkeypatch):
    """Each script parses its flags, builds its environment on the
    requested device and hands it and a random policy to ``launch``."""
    import importlib

    module = importlib.import_module({
        "suite": "dm_control_torch.suite.explore",
        "manipulation": "dm_control_torch.manipulation.explore",
        "soccer": "dm_control_torch.locomotion.soccer.explore",
        "examples": "dm_control_torch.locomotion.examples.explore"}[script])
    launched = {}

    def fake_launch(environment_loader=None, policy=None, **kwargs):
        env = (environment_loader() if callable(environment_loader)
               else environment_loader)
        launched.update(env=env, policy=policy)
        return "launched"

    monkeypatch.setattr(viewer, "launch", fake_launch)
    assert module.main(argv + ["--device=cpu"]) == "launched"
    env = launched["env"]
    assert env.physics.model.device.type == "cpu"
    if launched["policy"] is not None:
        ts = env.reset()
        action = launched["policy"](ts)
        env.step(action)
    with pytest.raises(SystemExit):
        module.parse_args(["--no-such-flag"])
