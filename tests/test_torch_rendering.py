"""The port's renderer against the JAX package's, on the CPU, in float32.

- ``raster.render_rays`` on the same seeded arrays as JAX's: every geom
  type (planes infinite and finite, a height field's box, sphere,
  capsule, ellipsoid, cylinder, box, a mesh by its k-DOP, its bounding
  sphere or its box) and an invisible geom.
- ``camera_pose`` and ``Camera.matrix`` of every camera mode (fixed,
  track, trackcom, targetbody, targetbodycom, the free camera) of a small
  inline model compiled by both packages: equal.
- ``Physics.render`` (rgb, depth, segmentation) of that model from each
  camera, ``MovableCamera``, suite scenes with the port's state (nothing
  of them compiled in JAX), ``MultiplayerTrackingCamera`` in a
  ``soccer.Task`` through a reset and a step, ``pixels.Wrapper`` and
  ``MujocoCamera``.
- The recorded scenes of ``rendering.golden`` (``tests/data/
  torch_render_*.npz``): the port's CPU frames against the JAX frames in
  the files; ``-m slow`` checks that the files equal a fresh JAX render.

The JAX frames come from ``tools/jax_render.py``: one process for the
module whose XLA CPU backend has no fused multiply-add, so that both
sides round each float32 operation alone (with FMA, grazing rays'
depths differ by up to 7e-4 m).  Gate (``rendering.golden.GATE``):
segmentation equal on at least 99.9% of the pixels; where it is equal,
plane depth within 1e-5 x max(1, depth) and each channel within 1 level.
Each frame test prints its figures (``-s``).
"""

import types

import numpy as np
import pytest
import torch

from _torch_helpers import ROOT, jax_render_tool
from dm_control_torch import composer as tcomposer
from dm_control_torch import rendering, suite
from dm_control_torch.composer.observation import MujocoCamera, Updater
from dm_control_torch.locomotion import soccer as tsoccer
from dm_control_torch.mjcf.mesh import kdop_supports
from dm_control_torch.physics.physics import Physics
from dm_control_torch.rendering import camera as tcamera
from dm_control_torch.rendering import golden
from dm_control_torch.rendering import raster
from dm_control_torch.suite.wrappers import pixels

F32 = np.float32

#: every geom type and camera mode; no collisions (rendering needs none)
XML = """
<mujoco>
  <default><geom contype="0" conaffinity="0"/></default>
  <asset>
    <hfield name="terrain" nrow="3" ncol="3" size=".6 .4 .3 .1"/>
    <mesh name="octa"
          vertex="0.2 0 0  -0.2 0 0  0 0.2 0  0 -0.2 0  0 0 0.25  0 0 -0.15"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 .1" rgba=".5 .5 .5 1"/>
    <geom name="tile" type="plane" pos="0 0 .001" size=".5 .5 .1"
          rgba=".2 .3 .6 1"/>
    <geom name="terrain" type="hfield" hfield="terrain" pos="1.5 1 0"
          rgba=".4 .6 .3 1"/>
    <camera name="fixed" pos="0 -3 1" xyaxes="1 0 0 0 .3 1"/>
    <camera name="target" mode="targetbody" target="arm" pos="2 -2 2"/>
    <camera name="targetcom" mode="targetbodycom" target="arm"
            pos="-2 -2 1.5"/>
    <body name="arm" pos="0 0 .8">
      <joint name="swing" type="hinge" axis="0 1 0"/>
      <joint name="slide" type="slide" axis="1 0 0"/>
      <geom name="upper" type="capsule" fromto="0 0 0 .4 0 .1" size=".07"
            rgba=".8 .3 .2 1"/>
      <geom name="head" type="sphere" pos="0 0 .25" size=".12"
            rgba=".9 .8 .2 1"/>
      <geom name="ghost" type="sphere" pos="0 -.3 0" size=".2"
            rgba="1 1 1 0"/>
      <camera name="track" mode="track" pos="0 -2.5 .5"
              xyaxes="1 0 0 0 .2 1"/>
      <camera name="trackcom" mode="trackcom" pos="0 -2.5 .5"
              xyaxes="1 0 0 0 .2 1"/>
      <body name="hand" pos=".4 0 .1">
        <joint name="wrist" type="hinge" axis="0 0 1"/>
        <geom name="palm" type="box" size=".1 .06 .04" rgba=".2 .7 .7 1"/>
        <geom name="can" type="cylinder" pos=".15 0 0" size=".05 .08"
              rgba=".6 .2 .8 1"/>
        <geom name="egg" type="ellipsoid" pos="0 .15 0" size=".05 .08 .12"
              rgba=".9 .5 .7 1"/>
        <geom name="gem" type="mesh" mesh="octa" pos="0 -.2 .1"
              rgba=".3 .9 .4 1"/>
        <camera name="eye" pos=".1 0 .2" xyaxes="0 -1 0 0 0 1"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
CAMERAS = [-1, 0, 1, 2, 3, 4, 5]  # free; fixed, target(com), track(com), eye
H, W = 48, 64
#: suite scenes (domain, task, camera) rendered from the port's state
SUITE_SCENES = [("cartpole", "swingup", 0), ("quadruped", "escape", 2),
                ("humanoid", "run", 1)]
POSE = (np.array([0.2, 0.1, 0.7]), 2.5, 60.0, -25.0)


def _rays_args(mesh):
    """Seeded float32 arguments of ``render_rays``: planes, a height
    field's box, each primitive and a mesh, one geom invisible."""
    rng = np.random.RandomState(0)
    types_ = [0, 1, 2, 3, 4, 5, 6, 7, 2, 6, 3, 0]
    G = len(types_)
    pos = rng.uniform(-1, 1, (G, 3))
    pos[:, 1] += 3.0
    mat = np.stack([np.linalg.qr(rng.randn(3, 3))[0] for _ in range(G)])
    mat *= np.sign(np.linalg.det(mat))[:, None, None]
    size = rng.uniform(0.1, 0.4, (G, 3))
    pos[0], mat[0], size[0] = [0, 0, -0.5], np.eye(3), [3, 3, 0.1]
    pos[11], mat[11], size[11] = [0, 0, -0.8], np.eye(3), [0, 0, 0.1]
    rgba = rng.uniform(0.2, 1, (G, 4))
    rgba[:, 3] = 1
    rgba[8, 3] = 0  # invisible
    kdop = np.zeros((G, 26))
    kdop[7] = kdop_supports(rng.randn(20, 3) * 0.3)
    yy, xx = np.meshgrid(np.linspace(-0.5, 0.5, 60),
                         np.linspace(-0.7, 0.7, 80), indexing="ij")
    fwd = np.array([0, 1, -0.4]) / np.linalg.norm([0, 1, -0.4])
    right = np.cross(fwd, [0, 0, 1])
    right /= np.linalg.norm(right)
    dirs = fwd + xx.reshape(-1, 1) * right + yy.reshape(-1, 1) * np.cross(
        right, fwd)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    arrays = [a.astype(F32) for a in (np.array([0.3, -2.0, 1.5]), dirs, pos,
                                      mat, size, np.linalg.norm(size, axis=1),
                                      rgba)]
    return arrays, types_, dict(mesh_as_sphere=mesh == "sphere",
                                geom_kdop=kdop.astype(F32)
                                if mesh == "kdop" else None)


@pytest.fixture(scope="module")
def model_physics():
    p = Physics.from_xml_string(XML, device="cpu")
    p.set_state(np.array([0.3, 0.1, 0.5, 0.0, 0.0, 0.0]))
    p.forward()
    return p


@pytest.fixture(scope="module")
def suite_physics():
    out = {}
    for domain, task, _ in SUITE_SCENES:
        env = suite.load(domain, task, task_kwargs={"random": 3},
                         device="cpu", dtype=torch.float32)
        env.reset()
        env.step(np.zeros(env.action_spec().shape))
        out[domain] = env.physics
    return out


@pytest.fixture(scope="module")
def soccer_env():
    """A 1v1 ``soccer.Task`` with a tracking camera, through a reset and a
    control step; returns (env, camera, its pose after the reset)."""
    cam = tsoccer.MultiplayerTrackingCamera(
        min_distance=2.0, distance_factor=1.0, smoothing_update_speed=0.5,
        width=64, height=48)
    with pytest.raises(ValueError, match="initialized"):
        cam.render()
    task = tsoccer.Task(tsoccer.task.standard_players(1),
                        tsoccer.Pitch(size=(12, 9)), tracking_cameras=(cam,))
    env = tcomposer.Environment(task, time_limit=5.0, random_state=3,
                                device="cpu", dtype=torch.float32)
    env.reset()
    first = cam.camera.get_pose()
    env.step(np.random.RandomState(3).uniform(-1, 1,
                                              env.action_spec().shape))
    return env, cam, first


@pytest.fixture(scope="module")
def jax_frames(model_physics, suite_physics, soccer_env):
    """Every JAX frame of the module, rendered in one process."""
    tool = jax_render_tool()
    jobs = {}
    for mesh in ("kdop", "sphere", "box"):
        arrays, types_, kw = _rays_args(mesh)
        jobs[f"rays_{mesh}"] = tool.rays_job(*arrays, types_, **kw)
    for cam in CAMERAS:
        jobs[f"model_{cam}"] = tool.scene_job(model_physics, H, W, cam)
    jobs["movable"] = tool.scene_job(model_physics, H, W,
                                     pose=np.r_[POSE[0], POSE[1:]])
    for domain, _, cam in SUITE_SCENES:
        jobs[domain] = tool.scene_job(suite_physics[domain], 60, 80, cam)
    env, cam, _ = soccer_env
    p = cam.camera.get_pose()
    jobs["soccer"] = tool.scene_job(
        env.physics, 48, 64, pose=np.r_[p.lookat, p.distance, p.azimuth,
                                        p.elevation])
    out = tool.render(list(jobs.values()))
    return dict(zip(jobs, out))


def _check(ours, ref, what):
    fig = golden.frame_figures(ours, ref)
    print(f"{what}: {fig}")
    assert golden.within_gate(fig), (what, fig, golden.GATE)
    assert ours["rgb"].dtype == np.uint8 and ours["depth"].dtype == F32
    return fig


@pytest.mark.parametrize("mesh", ["kdop", "sphere", "box"])
def test_render_rays_matches_jax(mesh, jax_frames):
    arrays, types_, kw = _rays_args(mesh)
    kw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    rgb, zdist, segid = raster.render_rays(
        *(torch.as_tensor(a) for a in arrays), types_, **kw)
    ref = jax_frames[f"rays_{mesh}"]
    same = segid.numpy() == ref["segid"]
    depth = np.abs(zdist.numpy() - ref["zdist"]) / np.maximum(
        1.0, ref["zdist"])
    levels = np.abs(rgb.numpy().astype(int) - ref["rgb"]).max(axis=-1)
    print(f"rays {mesh}: seg {same.mean()}, depth {depth[same].max()}, "
          f"rgb {levels[same].max()}")
    # every geom but the invisible one (8) is seen
    assert set(np.unique(ref["segid"])) == {-1} | set(range(12)) - {8}
    assert same.mean() >= golden.GATE["seg"]
    assert depth[same].max() <= golden.GATE["depth"]
    assert levels[same].max() <= golden.GATE["rgb"]


@pytest.fixture(scope="module")
def jax_model():
    from dm_control_tpu import mjcf as jmjcf

    return jmjcf.compile_xml_string(XML)


@pytest.mark.parametrize("camera", CAMERAS)
def test_camera_pose_and_matrix_match_jax(camera, model_physics, jax_model):
    from dm_control_tpu.rendering import camera as jcamera

    p = model_physics
    shim = types.SimpleNamespace(model=jax_model, data=types.SimpleNamespace(
        **{f: getattr(p.data, f).numpy() for f in golden.STATE_FIELDS}))
    if camera >= 0:
        assert p.model.cam_mode[camera] == jax_model.cam_mode[camera]
    jpos, jmat, jfovy = jcamera.camera_pose(shim, camera)
    pos, mat, fovy = (x.numpy() for x in tcamera.camera_pose(p, camera))
    np.testing.assert_allclose(pos, jpos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mat, jmat, rtol=0, atol=1e-12)
    assert float(fovy) == pytest.approx(jfovy, abs=1e-12)
    np.testing.assert_allclose(
        tcamera.Camera(p, H, W, camera).matrix,
        jcamera.Camera(shim, H, W, camera).matrix, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("camera", CAMERAS)
def test_physics_render_matches_jax(camera, model_physics, jax_frames):
    p = model_physics
    ours = {"rgb": p.render(H, W, camera),
            "depth": p.render(H, W, camera, depth=True),
            "seg": p.render(H, W, camera, segmentation=True)}
    assert ours["rgb"].shape == (H, W, 3) and ours["depth"].shape == (H, W)
    seg = ours.pop("seg")
    assert seg.shape == (H, W, 2) and seg.dtype == np.int32
    assert np.array_equal(seg[..., 1] == 5, seg[..., 0] >= 0)
    ours["seg"] = seg[..., 0]
    _check(ours, jax_frames[f"model_{camera}"], f"camera {camera}")
    # the invisible geom never wins
    assert p.model.names.geom["ghost"] not in ours["seg"]
    with pytest.raises(ValueError, match="exclusive"):
        p.render(H, W, camera, depth=True, segmentation=True)


def test_movable_camera_matches_jax(model_physics, jax_frames):
    cam = rendering.MovableCamera(model_physics, H, W)
    stat = model_physics.model.stat
    pose = cam.get_pose()
    np.testing.assert_allclose(pose.lookat, stat.center.numpy())
    assert pose.distance == pytest.approx(1.5 * float(stat.extent))
    cam.set_pose(*POSE)
    assert cam.get_pose().azimuth == POSE[2]
    _check(golden.camera_frames(cam), jax_frames["movable"], "movable")


@pytest.mark.parametrize("domain,task,camera", SUITE_SCENES)
def test_suite_frames_match_jax(domain, task, camera, suite_physics,
                                jax_frames):
    """The suite single environment's ``physics.render`` of the port's
    state against JAX's renderer of the same arrays."""
    cam = tcamera.Camera(suite_physics[domain], 60, 80, camera)
    fig = _check(golden.camera_frames(cam), jax_frames[domain],
                 f"{domain}:{task}")
    assert fig["seg"] >= golden.GATE["seg"]


def test_tracking_camera_in_a_soccer_task(soccer_env, jax_frames):
    """``soccer.Task(tracking_cameras=...)``: compiled, the camera starts
    at its target pose; a step pulls it half way to the new target; its
    frame matches JAX's ``MovableCamera`` at the same pose."""
    env, cam, first = soccer_env
    task = env.task
    positions = task._tracked_entity_positions(env.physics)
    target = cam._get_target_camera_pose(positions)
    pose = cam.camera.get_pose()
    np.testing.assert_allclose(pose.lookat,
                               0.5 * (target.lookat + first.lookat))
    assert pose.distance == pytest.approx(0.5 * (target.distance
                                                 + first.distance))
    assert first.distance >= 2.0 and pose.azimuth == 90.0
    frame = cam.render()
    assert frame.shape == (48, 64, 3) and frame.dtype == np.uint8
    _check(golden.camera_frames(cam.camera), jax_frames["soccer"],
           "soccer tracking")


@pytest.mark.parametrize("pixels_only", [True, False])
def test_pixels_wrapper(pixels_only):
    env = suite.load("cartpole", "balance", task_kwargs={"random": 3},
                     device="cpu")
    wrapped = pixels.Wrapper(env, pixels_only=pixels_only, render_kwargs={
        "height": 24, "width": 32, "camera_id": 1})
    spec = wrapped.observation_spec()
    keys = ["pixels"] if pixels_only else list(env.observation_spec()) + [
        "pixels"]
    assert list(spec) == keys
    assert spec["pixels"].shape == (24, 32, 3)
    assert spec["pixels"].dtype == np.uint8
    assert wrapped.action_spec() == env.action_spec()
    for act in (wrapped.reset, lambda: wrapped.step(np.zeros(1))):
        ts = act()
        assert list(ts.observation) == keys
        np.testing.assert_array_equal(ts.observation["pixels"],
                                      env.physics.render(24, 32, 1))
    assert pixels.STATE_KEY == "state" and pixels._RENDER_BACKEND is None
    pixels.set_render_backend(lambda physics, h, w, c: np.zeros((h, w, 3)))
    try:
        assert not wrapped.reset().observation["pixels"].any()
    finally:
        pixels.set_render_backend(None)


def test_mujoco_camera_observable(model_physics):
    cam = MujocoCamera("fixed", height=24, width=32)
    cam.enabled = True
    depth_cam = MujocoCamera("fixed", height=24, width=32, depth=True)
    depth_cam.enabled = True
    assert cam.array_spec.shape == (24, 32, 3)
    assert depth_cam.array_spec.shape == (24, 32, 1)
    updater = Updater({"pixels": cam, "depth": depth_cam},
                      physics_steps_per_control_step=1)
    updater.reset(model_physics, np.random.RandomState(0))
    obs = updater.get_observation()
    assert obs["pixels"].dtype == np.uint8
    np.testing.assert_array_equal(obs["pixels"],
                                  model_physics.render(24, 32, "fixed"))
    assert obs["depth"].shape == (24, 32, 1) and obs["depth"].dtype == F32
    np.testing.assert_array_equal(
        obs["depth"][..., 0], model_physics.render(24, 32, 0, depth=True))


def _gold(name):
    path = f"{ROOT}/tests/data/torch_render_{name}.npz"
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(golden.SCENES))
def test_port_frames_meet_goldens(name):
    """The recorded state on the port's CPU renderer against the JAX
    frames of the recording."""
    gold = _gold(name)
    physics = golden.scene_physics(name, gold, "cpu")
    ours = golden.render_frames(physics, name, gold.get("pose"))
    scene = golden.SCENES[name]
    assert ours["rgb"].shape == (scene.height, scene.width, 3)
    _check(ours, gold, f"golden {name}")


@pytest.mark.slow
@pytest.mark.parametrize("name", list(golden.SCENES))
def test_goldens_equal_fresh_jax(name):
    """The recording's frames equal a fresh JAX render of its state on
    the scene's model (built anew, its fields held to the recording's)."""
    from _torch_helpers import export_tool

    gold = _gold(name)
    physics = golden.scene_physics(name, gold, "cpu")
    fresh = export_tool().jax_render_frames(name, physics, gold)
    for k in golden.KINDS:
        np.testing.assert_array_equal(fresh[k], gold[k], err_msg=k)
