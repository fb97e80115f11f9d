"""The port's mocap clip files and what reads them, against the JAX
package's, on the CPU.

- ``HDF5TrajectoryLoader`` on ``dm_control``'s ``test_trajectories.h5``
  (the reference layout) and on a flat-layout file written here: the
  keys, and every feature of every clip and of a sub-trajectory, bit for
  bit.
- Protobuf banks: a bank written by either package's
  ``save_trajectory_bank`` read by the other's ``ProtoTrajectoryLoader``,
  the two files' bytes equal; the port's messages are the JAX file's but
  for their file name and package.
- ``datasets``: the registry equal to the JAX package's, the loader
  intersection and ``get_dataset``'s two errors.
- ``CMUMocapInitializer`` on the CMU 2019 humanoid, from a written CMU
  2019 h5 and from the synthetic clip: qpos and qvel within 1e-12 of the
  JAX initializer's (float64), the generators' states equal.
- ``cmu_humanoid_tracking`` from a written ``cmu_2020_dfe3e9e0.h5`` under
  ``CMU_MOCAP_DIR`` (walk_tiny's clips that the file has) and without a
  file (the synthetic clips): its clips equal the JAX environment's.
- ``mocap_demo``'s playback of the AMC clip of ``tests/test_scripts.py``:
  the converted clip and the head's heights against the JAX package's
  ``parse_amc`` and kinematics.
- No new module imports JAX, ``h5py`` or protobuf; the default device of
  the new entry points is the card.

JAX environments are built with ``composer.Environment`` replaced (no
MJCF compile, nothing jitted).  Marked ``slow``: an episode of
``cmu_humanoid_tracking`` replayed one control step at a time against a
fresh JAX episode (``rl/golden.py::host_episode_errors``).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_helpers import export_tool, jax_model_from_asset
from dm_control_torch.locomotion.mocap import loader as tloader
from dm_control_torch.locomotion.mocap.trajectory import Trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_H5 = os.path.join(
    os.path.dirname(__import__("dm_control.locomotion.mocap",
                               fromlist=["x"]).__file__),
    "test_trajectories.h5")
#: the modules this slice adds to the port (the protobuf module apart:
#: it is protobuf's)
NEW_MODULES = (
    "dm_control_torch.locomotion.mocap.loader",
    "dm_control_torch.locomotion.mocap.proto",
    "dm_control_torch.locomotion.tasks.reference_pose.cmu_subsets",
    "dm_control_torch.locomotion.tasks.reference_pose.datasets",
    "dm_control_torch.locomotion.tasks.reference_pose.tracking",
    "dm_control_torch.locomotion.walkers.initializers.mocap",
    "dm_control_torch.locomotion.examples.cmu_2020_tracking",
    "dm_control_torch.suite.demos.mocap_demo",
    "dm_control_torch.scripts.model",
    "dm_control_torch.scripts.ppo",
    "dm_control_torch.scripts.vec_env",
    "dm_control_torch.scripts.ppo_tracking",
)
BLOCKED = ("jax", "jaxlib", "flax", "optax", "absl", "h5py", "google.protobuf",
           "dm_control_tpu")


def _clip(nq, nv, steps, seed, identifier):
    return tloader.synthetic_walking_trajectory(
        nq=nq, nv=nv, num_steps=steps, seed=seed, identifier=identifier)


def write_reference_h5(path, clips, dt=0.03):
    """Clips {id: Trajectory} as the reference's h5 layout: a group a clip
    with ``dt``, its walker's features as (dim, T) arrays under
    ``walkers/walker_0``."""
    import h5py

    with h5py.File(path, "w") as f:
        for cid, clip in clips.items():
            group = f.create_group(cid)
            group.attrs["dt"] = dt
            w = group.create_group("walkers/walker_0")
            qpos, qvel = clip["qpos"], clip["qvel"]
            for key, value in (("position", qpos[:, :3]),
                               ("quaternion", qpos[:, 3:7]),
                               ("joints", qpos[:, 7:]),
                               ("velocity", qvel[:, :3]),
                               ("angular_velocity", qvel[:, 3:6]),
                               ("joints_velocity", qvel[:, 6:])):
                w.create_dataset(key, data=value.T)
    return path


def _write_flat_h5(path):
    import h5py

    rng = np.random.RandomState(3)
    with h5py.File(path, "w") as f:
        for i, steps in enumerate((7, 12)):
            group = f.create_group(f"flat_{i}")
            if i:
                group.attrs["dt"] = 0.02
            group.create_dataset("qpos", data=rng.randn(steps, 9))
            group.create_dataset("qvel", data=rng.randn(steps, 8))
            group.create_dataset("center_of_mass", data=rng.randn(steps, 3))
    return path


def _assert_same_clip(ours, theirs):
    assert ours.identifier == theirs.identifier
    assert ours.dt == theirs.dt and ours.num_steps == theirs.num_steps
    assert list(ours.keys()) == list(theirs.keys())
    for k in theirs.keys():
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# -- the clip files -----------------------------------------------------------


@pytest.mark.parametrize("layout", ["reference", "flat"])
def test_hdf5_loader_matches_jax(layout, tmp_path):
    from dm_control_tpu.locomotion.mocap import loader as jloader

    path = (TEST_H5 if layout == "reference"
            else _write_flat_h5(str(tmp_path / "flat.h5")))
    ours, theirs = (tloader.HDF5TrajectoryLoader(path),
                    jloader.HDF5TrajectoryLoader(path))
    assert ours.keys() == theirs.keys() and len(ours.keys()) == 2
    for key in theirs.keys():
        _assert_same_clip(ours.get_trajectory(key),
                          theirs.get_trajectory(key))
        _assert_same_clip(ours.get_trajectory(key, start_step=2, end_step=6),
                          theirs.get_trajectory(key, start_step=2,
                                                end_step=6))
        _assert_same_clip(ours.get_trajectory(key, start_step=3),
                          theirs.get_trajectory(key, start_step=3))
    if layout == "reference":
        frame = ours.get_trajectory("cmuv2019_001").get_timestep_data(0)
        assert frame["qpos"].shape == (63,) and frame["qvel"].shape == (62,)
        assert frame["body_quaternions"].shape == (30, 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_proto_banks_cross_read(writer, tmp_path):
    """A bank written by one package reads in the other (the clips' qpos,
    qvel, dt and ids, a clip without qvel too); both write the same
    bytes."""
    from dm_control_tpu.locomotion.mocap import loader as jloader
    from dm_control_tpu.locomotion.mocap.trajectory import (
        Trajectory as JTrajectory,
    )

    rng = np.random.RandomState(5)
    arrays = {"a": (rng.randn(6, 9), rng.randn(6, 8), 0.03),
              "b": (rng.randn(4, 9), None, 0.05)}

    def clips(cls):
        return {cid: cls({"qpos": q} if v is None else {"qpos": q, "qvel": v},
                         dt=dt, identifier=cid)
                for cid, (q, v, dt) in arrays.items()}

    paths = {}
    for name, lib, cls in (("jax", jloader, JTrajectory),
                           ("port", tloader, Trajectory)):
        paths[name] = str(tmp_path / f"{name}.pb")
        lib.save_trajectory_bank(paths[name], clips(cls))
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    reader = (tloader if writer == "jax" else jloader).ProtoTrajectoryLoader(
        paths[writer])
    assert reader.keys() == ["a", "b"]
    for cid, (q, v, dt) in arrays.items():
        clip = reader.get_trajectory(cid)
        assert clip.dt == dt and clip.identifier == cid
        np.testing.assert_array_equal(clip["qpos"], q)
        assert ("qvel" in clip.keys()) == (v is not None)
        if v is not None:
            np.testing.assert_array_equal(clip["qvel"], v)
    sub = reader.get_trajectory("a", start_step=1, end_step=4)
    np.testing.assert_array_equal(sub["qvel"], arrays["a"][1][1:4])


def test_proto_messages_are_the_jax_files():
    """The port's file descriptor is the JAX package's with the file name
    and package renamed."""
    from google.protobuf import descriptor_pb2

    from dm_control_tpu.locomotion.mocap.proto import mocap_pb2 as jpb
    from dm_control_torch.locomotion.mocap.proto import mocap_pb2 as tpb

    protos = []
    for module in (jpb, tpb):
        fdp = descriptor_pb2.FileDescriptorProto()
        module.DESCRIPTOR.CopyToProto(fdp)
        text = str(fdp).replace(module.DESCRIPTOR.package, "PKG")
        protos.append(text.replace(module.DESCRIPTOR.name, "FILE"))
    assert protos[0] == protos[1]
    assert tpb.DESCRIPTOR.name == "dm_control_torch/mocap.proto"
    assert tpb.TrajectoryBank.DESCRIPTOR.full_name == (
        "dm_control_torch.mocap.TrajectoryBank")


# -- datasets -----------------------------------------------------------------


def test_datasets_match_jax():
    from dm_control_tpu.locomotion.tasks.reference_pose import (
        datasets as jdatasets,
    )
    from dm_control_torch.locomotion.tasks.reference_pose import datasets

    assert datasets.names() == jdatasets.names()
    for name in jdatasets.names():
        assert datasets.DATASETS[name] == type(datasets.DATASETS[name])(
            **vars(jdatasets.DATASETS[name])), name
    assert len(datasets.get_dataset("walk_tiny").ids) == 36
    walk = datasets.get_dataset("walk_tiny").ids
    bank = types.SimpleNamespace(keys=lambda: [walk[5], "x", walk[1]])
    assert datasets.get_dataset("walk_tiny", loader=bank).ids == (walk[1],
                                                                  walk[5])
    assert datasets.available(bank).ids == (walk[5], "x", walk[1])
    with pytest.raises(KeyError, match="Unknown dataset"):
        datasets.get_dataset("walk_huge")
    with pytest.raises(ValueError, match="shares no clip ids"):
        datasets.get_dataset("get_up", loader=bank)
    datasets.register_subset("two_walks", walk[:2])
    try:
        assert datasets.get_dataset("two_walks").ids == walk[:2]
    finally:
        del datasets.DATASETS["two_walks"]


# -- the initializer ----------------------------------------------------------


@pytest.mark.parametrize("source", ["h5", "synthetic"])
def test_mocap_initializer_matches_jax(source, tmp_path, monkeypatch):
    """The CMU 2019 humanoid put at a drawn frame of CMU_077_02 (written to
    a CMU 2019 h5 under ``CMU_MOCAP_DIR``) or of the synthetic clip: its
    qpos and qvel within 1e-12 of the JAX initializer's, three draws from
    equal generators."""
    from _torch_helpers import jax_model_from_port
    from dm_control_tpu.locomotion import arenas as jarenas
    from dm_control_tpu.locomotion.walkers import cmu_humanoid as jcmu
    from dm_control_tpu.locomotion.walkers.initializers import (
        mocap as jmocap,
    )
    from dm_control_tpu.physics import physics as jphysics
    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_torch.locomotion import arenas as tarenas
    from dm_control_torch.locomotion.walkers import cmu_humanoid as tcmu
    from dm_control_torch.locomotion.walkers.initializers import (
        mocap as tmocap,
    )
    from dm_control_torch.physics.physics import Physics

    monkeypatch.setenv("CMU_MOCAP_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    walker = tcmu.CMUHumanoid()
    if source == "h5":
        write_reference_h5(str(tmp_path / "cmu_2019_08756c01.h5"), {
            "CMU_077_02": _clip(63, 62, 30, 4, "CMU_077_02"),
            "CMU_016_22": _clip(63, 62, 5, 5, "CMU_016_22")})
    arena = tarenas.Floor()
    arena.add_free_entity(walker)
    physics = Physics.from_mjcf_model(arena.mjcf_model, device="cpu")
    jm = jax_model_from_port(physics.model)
    jp = jphysics.Physics(jm, jmake_data(jm))
    jwalker = jcmu.CMUHumanoid()
    jarenas.Floor().add_free_entity(jwalker)
    ours, theirs = tmocap.CMUMocapInitializer(), jmocap.CMUMocapInitializer()
    assert (ours._trajectory is None) == (theirs._trajectory is None) == (
        source == "synthetic")
    rs, jrs = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        ours.initialize_pose(physics, walker, rs)
        theirs.initialize_pose(jp, jwalker, jrs)
        for field in ("qpos", "qvel"):
            np.testing.assert_allclose(
                getattr(physics.data, field).numpy(),
                np.asarray(getattr(jp.data, field)), rtol=0, atol=1e-12,
                err_msg=field)
        assert np.abs(physics.data.qvel.numpy()[:3]).max() > 0.5
    np.testing.assert_array_equal(rs.get_state()[1], jrs.get_state()[1])


# -- the CMU 2020 tracking environment ----------------------------------------


def _jax_tracking_task(monkeypatch):
    from dm_control_tpu import composer as jcomposer
    from dm_control_tpu.locomotion.examples import (
        cmu_2020_tracking as jexample,
    )

    with monkeypatch.context() as mp:
        mp.setattr(jcomposer, "Environment",
                   lambda task, **kw: types.SimpleNamespace(task=task, **kw))
        return jexample.cmu_humanoid_tracking(random_state=3).task


@pytest.mark.parametrize("source", ["h5", "synthetic"])
def test_cmu_humanoid_tracking_clips_match_jax(source, tmp_path,
                                               monkeypatch):
    """walk_tiny's clips of a written CMU 2020 h5 (three of its ids and
    one id it does not name), or the three synthetic clips: the task's
    clips, in order, equal the JAX environment's; a reset and a control
    step on the CPU."""
    from dm_control_torch.locomotion.examples import cmu_2020_tracking
    from dm_control_torch.locomotion.tasks.reference_pose import datasets

    monkeypatch.setenv("CMU_MOCAP_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    walk = datasets.get_dataset("walk_tiny").ids
    if source == "h5":
        write_reference_h5(str(tmp_path / "cmu_2020_dfe3e9e0.h5"), {
            cid: _clip(63, 62, 40 + i, i, cid)
            for i, cid in enumerate((walk[7], "CMU_999_99", walk[0],
                                     walk[20]))})
    env = cmu_2020_tracking.cmu_humanoid_tracking(random_state=3,
                                                  device="cpu")
    task = env.task
    theirs = _jax_tracking_task(monkeypatch)._trajectories
    assert list(task._trajectories) == list(theirs)
    assert list(theirs) == ([walk[0], walk[7], walk[20]] if source == "h5"
                            else [f"synthetic_walk_{k}" for k in range(3)])
    for cid in theirs:
        _assert_same_clip(task._trajectories[cid], theirs[cid])
    ts = env.reset()
    assert ts.observation["walker/joints_pos"].shape == (56,)
    ts = env.step(np.zeros(env.action_spec().shape))
    assert ts.mid() and np.isfinite(ts.reward)
    assert env.physics.model.dtype == torch.float64


def test_tracking_task_reads_a_clip_file(tmp_path):
    """``MultiClipMocapTracking(walker, arena, path)``: every clip of the
    file, or the dataset's; the batched path tracks the same bank."""
    from dm_control_torch.composer import compile_task
    from dm_control_torch.locomotion.arenas import Floor
    from dm_control_torch.locomotion.mocap.types import ClipCollection
    from dm_control_torch.locomotion.tasks.reference_pose import (
        MultiClipMocapTracking,
    )
    from dm_control_torch.locomotion.walkers import RollingBallWithHead

    nq = 7 + len(RollingBallWithHead().observable_joint_names)
    clips = {f"clip{i}": _clip(nq, nq - 1, 20 + 5 * i, i, f"clip{i}")
             for i in range(3)}
    path = write_reference_h5(str(tmp_path / "clips.h5"), clips)
    every = MultiClipMocapTracking(RollingBallWithHead(), Floor(), path)
    assert list(every._trajectories) == list(clips)
    picked = MultiClipMocapTracking(
        RollingBallWithHead(), Floor(), path,
        dataset=ClipCollection(ids=("clip2", "clip0")))
    assert list(picked._trajectories) == ["clip2", "clip0"]
    for cid, clip in clips.items():
        np.testing.assert_array_equal(every._trajectories[cid]["qpos"],
                                      clip["qpos"])
    env = compile_task(picked, device="cpu", dtype=torch.float64,
                       time_limit=1.0)
    state, ts = env.reset(4, torch.Generator().manual_seed(0))
    bank = picked._clip_bank(env.model)
    assert bank["ends"].tolist() == [30, 20]
    assert torch.isfinite(ts.reward).all()


# -- mocap_demo ---------------------------------------------------------------


def _write_amc(path):
    """The AMC clip of ``tests/test_scripts.py::test_parse_amc_against_
    oracle``: 12 frames of every CMU joint, drawn from RandomState(0)."""
    joints = [("root", 6), ("lowerback", 3), ("upperback", 3),
              ("thorax", 3), ("lowerneck", 3), ("upperneck", 3),
              ("head", 3), ("rclavicle", 2), ("rhumerus", 3),
              ("rradius", 1), ("rwrist", 1), ("rhand", 2),
              ("rfingers", 1), ("rthumb", 2), ("lclavicle", 2),
              ("lhumerus", 3), ("lradius", 1), ("lwrist", 1),
              ("lhand", 2), ("lfingers", 1), ("lthumb", 2),
              ("rfemur", 3), ("rtibia", 1), ("rfoot", 2), ("rtoes", 1),
              ("lfemur", 3), ("ltibia", 1), ("lfoot", 2), ("ltoes", 1)]
    rng = np.random.RandomState(0)
    lines = [":FULLY-SPECIFIED", ":DEGREES"]
    for t in range(1, 13):
        lines.append(str(t))
        for name, n in joints:
            vals = (rng.randn(n) * 5).round(4)
            if name == "root":
                vals[:3] = [t * 0.1, 17.0, t * 0.05]
            lines.append(name + " " + " ".join(map(str, vals)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_mocap_demo_matches_jax(tmp_path, capsys):
    """The port's playback: the converted clip bit for bit against the
    JAX package's ``parse_amc.convert`` on humanoid_CMU, the head's height
    at each of 8 frames within 1e-12 of the JAX kinematics'.  (The JAX
    demo's own ``main`` stops at ``env.physics.reset_context``, which its
    environment's physics view lacks.)"""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics import kinematics as jkin
    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_tpu.suite.utils import parse_amc as jamc
    from dm_control_torch.suite.demos import mocap_demo

    path = _write_amc(str(tmp_path / "clip.amc"))
    converted, heights = mocap_demo.playback(path, max_num_frames=8,
                                             device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out == ["clip: 46 frames at dt=0.002",
                   f"frame 0: head height {heights[0]:.3f}",
                   "playback done"]
    jm = jax_model_from_asset("humanoid_CMU")
    theirs = jamc.convert(path, types.SimpleNamespace(model=jm),
                          float(jm.opt.timestep))
    for field in ("qpos", "qvel", "time"):
        np.testing.assert_array_equal(getattr(converted, field),
                                      getattr(theirs, field), err_msg=field)
    d, head = jmake_data(jm), jm.names.body["head"]
    height = jax.jit(jax.vmap(
        lambda q: jkin.kinematics(jm, d.replace(qpos=q)).xpos[head, 2]))
    expected = np.asarray(height(jnp.asarray(theirs.qpos[:, :8].T)))
    assert heights.shape == (8,)
    np.testing.assert_allclose(heights, expected, rtol=0, atol=1e-12)
    with pytest.raises(SystemExit, match="--filename"):
        mocap_demo.main(["--device=cpu"])


# -- imports and devices ------------------------------------------------------


def test_new_modules_import_without_jax_h5py_or_protobuf():
    """Every new module imports with JAX, flax, optax, absl, h5py,
    protobuf and the JAX package blocked; the protobuf module imports
    with protobuf alone."""
    code = (
        "import sys, importlib\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "del sys.modules['google.protobuf']\n"
        "from dm_control_torch.locomotion.mocap.proto import mocap_pb2\n"
        "assert mocap_pb2.TrajectoryBank.DESCRIPTOR\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and"
        " m.split('.')[0] in"
        " ('jax', 'flax', 'optax', 'h5py', 'dm_control_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is here")
def test_default_device_is_the_card():
    from dm_control_torch.locomotion.examples import cmu_2020_tracking
    from dm_control_torch.scripts import model, ppo, ppo_tracking
    from dm_control_torch.suite.demos import mocap_demo

    for call in (cmu_2020_tracking.cmu_humanoid_tracking,
                 ppo_tracking.build_env,
                 lambda: mocap_demo.playback("clip.amc"),
                 lambda: ppo.PPOTrainer(model.ActorCritic(3, 2), None, None,
                                        ppo.PPOTrainerConfig()),
                 lambda: ppo_tracking.main(["--max_epochs=0"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert ppo_tracking.parse_args([]).device == "cuda"
    assert mocap_demo.parse_args([]).device == "cuda"


# -- slow: an episode against a fresh JAX one ---------------------------------


@pytest.mark.slow
def test_cmu_humanoid_tracking_episode_matches_jax(tmp_path, monkeypatch):
    """An episode of ``cmu_humanoid_tracking`` from a written CMU 2020 h5:
    the JAX environment's reset and control steps recorded, the port's
    replayed one control step at a time from the recorded states, every
    timestep within the golden gate."""
    from dm_control_tpu.locomotion.examples import (
        cmu_2020_tracking as jexample,
    )
    from dm_control_torch.locomotion.examples import cmu_2020_tracking
    from dm_control_torch.locomotion.tasks.reference_pose import datasets
    from dm_control_torch.rl import golden as tgolden

    monkeypatch.setenv("CMU_MOCAP_DIR", str(tmp_path))
    walk = datasets.get_dataset("walk_tiny").ids
    write_reference_h5(str(tmp_path / "cmu_2020_dfe3e9e0.h5"), {
        cid: _clip(63, 62, 60, i, cid) for i, cid in enumerate(walk[:3])})
    tool = export_tool()
    jenv = jexample.cmu_humanoid_tracking(random_state=5)
    spec = jenv.action_spec()
    rng = np.random.RandomState(tool.ENV_ACTION_SEED)
    gold = tool._episode(jenv, np.stack([rng.uniform(spec.minimum,
                                                     spec.maximum)
                                         for _ in range(3)]))
    gold.update({f"model_{f}": np.asarray(getattr(jenv.physics.model, f))
                 for f in tgolden.HOST_MODEL_FIELDS})
    env = cmu_2020_tracking.cmu_humanoid_tracking(random_state=5,
                                                  device="cpu")
    errs = tgolden.host_episode_errors(env, gold)
    figures, ok = tgolden.episode_gate(errs, gold, "cmu_humanoid_tracking")
    assert ok, figures
    assert errs[0]["step_qpos"] == 0.0
