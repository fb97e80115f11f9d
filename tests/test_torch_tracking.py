"""The port's batched mocap tracking against the JAX package, in float64 on
the CPU: ``MultiClipMocapTracking`` -> ``composer.compile_task`` ->
``BatchEnv.reset/step``, with the rolling ball (the JAX package's tracking
bench rung: 4 synthetic clips, threshold 50) and the CMU 2020 humanoid
(its ``examples/cmu_2020_tracking.py``: 3 synthetic clips).

- From each tracking golden (``tools/export_torch_assets.py tracking``)
  one ``BatchEnv.step`` passes ``rl/golden.py``'s gate; the goldens carry
  each environment's clip and start frame (``_clip``, ``_start``).
- The ball task's observation, reward and termination equal the JAX
  task's batched hooks (vmapped) to 1e-10, at times that move the clip
  cursor and at states that truncate and that reach the clip's end; its
  clip bank equals JAX's ``_clip_bank`` to 1e-12, and its ``batch_init``
  JAX's on numpy draws.  The port's own draws follow the clip weights
  over B = 4096 and stay in each clip's start window.
- The ten reward functions equal JAX's, environment by environment, to
  1e-12; ``synthetic_walking_trajectory`` equals JAX's bit for bit; the
  walkers' names equal the JAX walkers'; walkers and floors built
  otherwise than the reference files compile to the JAX compiler's model
  and step.
- The clip cursor follows the step count over a whole float32 episode of
  the ball and the autoreset sets it back.

Marked ``slow``: the CMU task's hooks and clip bank against JAX's (the
JAX bank's kinematics of the CMU model takes minutes to compile here),
each golden file against a fresh JAX run, each asset against a fresh
export.
"""

import types

import numpy as np
import pytest
import torch

import test_torch_model_io as model_io_tests
import test_torch_tasks as tasks
from _torch_helpers import PREFIXES, assert_step_matches_golden, \
    export_tool, golden, jax_model, jax_model_from_asset
from dm_control_torch.composer import batch as tbatch
from dm_control_torch.locomotion.arenas import Floor
from dm_control_torch.locomotion.mocap import loader as tloader
from dm_control_torch.locomotion.mocap.types import ClipCollection
from dm_control_torch.locomotion.tasks.reference_pose import rewards as trw
from dm_control_torch.locomotion.tasks.reference_pose import tracking
from dm_control_torch.locomotion.walkers import (
    CMUHumanoidPositionControlledV2020, RollingBallWithHead,
    cmu_actuator_params,
)
from dm_control_torch.mjcf import compiler as tcompiler
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import model_io
from dm_control_torch.rl.control import FIRST, LAST, MID, RandomContext, \
    apply_model_diff

ASSETS = ("tracking_ball", "tracking_cmu2020")
TIME_LIMITS = {"tracking_ball": 10.0, "tracking_cmu2020": 30.0}
ATOL = 1e-10


def _task(asset, **kwargs):
    """The port's task of an asset, configured as the exporter's JAX one
    (``export_tool().locomotion_task``)."""
    synth = tloader.synthetic_walking_trajectory
    if asset == "tracking_ball":
        walker = RollingBallWithHead()
        nq = 7 + len(walker.observable_joint_names)
        trajs = {f"clip{i}": synth(nq=nq, nv=nq - 1, num_steps=120, seed=i)
                 for i in range(4)}
        kwargs.setdefault("dataset", ClipCollection(ids=tuple(trajs)))
        return tracking.MultiClipMocapTracking(
            walker, Floor(), trajs, termination_error_threshold=50.0,
            reward_type="comic", **kwargs)
    walker = CMUHumanoidPositionControlledV2020()
    njoint = len(walker.mocap_joint_names)
    trajs = {f"synthetic_walk_{k}": synth(
        nq=njoint + 7, nv=njoint + 6, seed=k,
        identifier=f"synthetic_walk_{k}") for k in range(3)}
    return tracking.MultiClipMocapTracking(
        walker=walker, arena=Floor(), ref_path_or_trajectories=trajs,
        ref_steps=(1, 2, 3, 4, 5), min_steps=10, reward_type="comic",
        **kwargs)


def _env(asset, dtype=torch.float64, autoreset=False, **kwargs):
    return tbatch.compile_task(_task(asset, **kwargs), device="cpu",
                               dtype=dtype, time_limit=TIME_LIMITS[asset],
                               autoreset=autoreset)


# -- the goldens ----------------------------------------------------------------


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("asset", ASSETS)
def test_batch_env_step_matches_golden(asset, prefix):
    gold = golden(f"locomotion_{asset}")
    assert {k for k in gold if k.startswith(f"{prefix}_diff_")} == {
        f"{prefix}_diff__clip", f"{prefix}_diff__start"}
    assert_step_matches_golden(_env(asset), gold, prefix)


@pytest.mark.parametrize("asset", ASSETS)
def test_golden_states_reach_the_new_code(asset):
    """The later states: the walker on the floor in every environment, the
    environments on different clips or start frames, the cursor past the
    start frame."""
    from dm_control_torch.rl.golden import start_state

    gold = golden(f"locomotion_{asset}")
    env = _env(asset)
    state = start_state(env, gold, "contact")
    m = apply_model_diff(env.model, state.model_diff)
    d = tengine.forward(m, env._unstrip(state.data))
    floor = m.names.geom["groundplane"]
    on_floor = [c for c, (g1, g2) in enumerate(zip(d.contact.geom1,
                                                  d.contact.geom2))
                if floor in (g1, g2)]
    assert bool((d.contact.dist[:, on_floor] < 0).any(-1).all())
    pairs = set(zip(state.model_diff["_clip"].tolist(),
                    state.model_diff["_start"].tolist()))
    assert len(pairs) == 4
    task = env.task._t
    np.testing.assert_array_equal(
        (task._batch_tstep(m, d) - m.task_state["_start"]).numpy(),
        export_tool().FALL_STEPS[f"locomotion_{asset}"])


# -- the hooks against the JAX task's -------------------------------------------


def _jax_task(asset):
    return export_tool().locomotion_task(asset)


def _hook_states(asset):
    """(env, qpos, qvel, time, diff, ctrl): the golden's start and stepped
    states at their times; in the ball's, state 0 at the last frame of its
    clip and state 1 far from the reference (past the threshold)."""
    gold = golden(f"locomotion_{asset}")
    env = _env(asset)
    tags = [(p, tag) for p in PREFIXES for tag in (p, f"{p}_step")]

    def cat(field):
        return torch.as_tensor(np.concatenate(
            [gold[f"{tag}_{field}"] for _, tag in tags]))

    qpos, qvel, time = cat("qpos"), cat("qvel"), cat("time")
    diff = {k: torch.as_tensor(np.concatenate(
        [gold[f"{p}_diff_{k}"] for p, _ in tags])) for k in ("_clip",
                                                             "_start")}
    if asset == "tracking_ball":
        task = env.task._t
        bank = task._clip_bank(env.model)
        k = int(round(float(time[0]) / task.control_timestep))
        diff["_start"][0] = int(bank["ends"][int(diff["_clip"][0])]) - 6 - k
        qpos[1, 0] += 400.0
    n = qpos.shape[0]
    ctrl = torch.as_tensor(np.random.default_rng(n).uniform(
        -1, 1, (n, env.model.nu)))
    return env, qpos, qvel, time, diff, ctrl


def _port_outputs(env, qpos, qvel, time, diff, ctrl):
    """(observation, reward, terminate, discount) and the Data they read,
    as ``BatchEnv`` hands the states to the task after a step."""
    n = qpos.shape[0]
    state = env.from_state(qpos, qvel, torch.zeros_like(qvel), time,
                           generator=torch.Generator().manual_seed(0),
                           model_diff=diff, act=tasks._act(n, env.model.na))
    m = apply_model_diff(env.model, diff)
    d = env.task.before_step(m, env._unstrip(state.data), ctrl)
    state, obs = env._observe(state.replace(data=d))
    d = state.data
    terminate, discount = env.task.termination(m, d)
    return (obs, env.task.reward(m, d), terminate, discount), d


@pytest.mark.parametrize("asset", [
    "tracking_ball", pytest.param("tracking_cmu2020",
                                  marks=pytest.mark.slow)])
def test_task_hooks_match_jax(asset):
    from dm_control_tpu.composer.batch import _PureTaskAdapter

    env, qpos, qvel, time, diff, ctrl = _hook_states(asset)
    n = qpos.shape[0]
    (obs, reward, terminate, discount), d = _port_outputs(
        env, qpos, qvel, time, diff, ctrl)
    jm = jax_model_from_asset(asset)
    jtask = _jax_task(asset)
    jtask._clip_bank(jm)  # outside the trace
    jenv = types.SimpleNamespace(model=jm, task=_PureTaskAdapter(jtask))
    jobs, jreward, jterminate, jdiscount = tasks._jax(
        None, None, qpos, qvel, diff, ctrl, env=jenv, port_data=d)
    assert list(obs) == list(jobs)
    for k, v in obs.items():
        assert v.shape[0] == n
        np.testing.assert_allclose(
            v.numpy().reshape(n, -1), np.asarray(jobs[k]).reshape(n, -1),
            rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(reward.numpy(), np.asarray(jreward), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(terminate.numpy(), np.asarray(jterminate))
    np.testing.assert_array_equal(discount.numpy(), np.asarray(jdiscount))
    assert float(reward.std()) > 1e-3
    if asset == "tracking_ball":  # the clip's end, then the threshold
        assert terminate[:2].tolist() == [True, True]
        assert discount[:2].tolist() == [1.0, 0.0]
        assert not bool(terminate[2:].any())


@pytest.mark.parametrize("asset", [
    "tracking_ball", pytest.param("tracking_cmu2020",
                                  marks=pytest.mark.slow)])
def test_clip_bank_matches_jax(asset):
    """The bank from the port's kinematics against the JAX task's
    ``_clip_bank``."""
    bank = _task(asset)._host_bank()
    jbank = _jax_task(asset)._clip_bank(jax_model_from_asset(asset))
    assert bank.keys() == jbank.keys()
    for k, v in bank.items():
        want = np.asarray(jbank[k])
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(v, want, rtol=0, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)


def test_task_init_matches_jax():
    """``batch_init`` of both packages on numpy draws of the same seeds:
    the same calls in the same order, the same starts."""
    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_tpu.rl.control import RandomContext as JRandomContext

    env = _env("tracking_ball")
    m, task = env.model, env.task._t
    jm = jax_model_from_asset("tracking_ball")
    jtask = _jax_task("tracking_ball")
    for seed in range(4):
        ours = np.random.RandomState(seed)
        theirs = np.random.RandomState(seed)
        qpos, qvel, diff = task.batch_init(
            m, m.qpos0.reshape(1, m.nq).clone(),
            torch.zeros(1, m.nv, dtype=m.dtype),
            RandomContext.numpy(ours, "cpu", m.dtype),
            task.batch_model_diff(m))
        jd = jmake_data(jm)
        jqpos, jqvel, jdiff = jtask.batch_init(
            jm, jd.qpos, jd.qvel, JRandomContext(np_random=theirs),
            jtask.batch_model_diff(jm))
        np.testing.assert_array_equal(qpos[0].numpy(), np.asarray(jqpos))
        np.testing.assert_array_equal(qvel[0].numpy(), np.asarray(jqvel))
        for k in ("_clip", "_start"):
            assert int(diff[k][0]) == int(jdiff[k]), k
        np.testing.assert_array_equal(ours.get_state()[1],
                                      theirs.get_state()[1])


def test_init_draws_follow_the_weights_and_windows():
    """The port's draws (a torch generator) over B = 4096: each clip drawn
    at its weight's share (within 5 standard deviations), each start in
    its clip's window and spread over it; with
    ``always_init_at_clip_start`` every start is its window's first."""
    weights = (0.1, 0.2, 0.3, 0.4)
    ids = tuple(f"clip{i}" for i in range(4))
    B = 4096
    for always in (False, True):
        task = _task("tracking_ball", always_init_at_clip_start=always,
                     dataset=ClipCollection(ids=ids, weights=weights,
                                            start_steps=(0, 10, 20, 30)))
        env = tbatch.compile_task(task, device="cpu", dtype=torch.float64)
        m = env.model
        qpos, qvel, diff = task.batch_init(
            m, m.qpos0.expand(B, m.nq), torch.zeros(B, m.nv, dtype=m.dtype),
            RandomContext(torch.Generator().manual_seed(3), B, m.dtype),
            task.batch_model_diff(m))
        clip, start = diff["_clip"].long(), diff["_start"].long()
        counts = torch.bincount(clip, minlength=4).numpy()
        p = np.asarray(weights)
        assert np.all(np.abs(counts - B * p) <= 5 * np.sqrt(B * p * (1 - p)))
        bank = task._clip_bank(m)
        lo, hi = bank["start_low"][clip], bank["max_start"][clip]
        np.testing.assert_array_equal(lo.numpy(),
                                      np.asarray([0, 10, 20, 30])[clip])
        if always:
            assert bool((start == lo).all())
        else:
            assert bool(((start >= lo) & (start < hi)).all())
            for c in range(4):
                s = start[clip == c]
                span = int(bank["max_start"][c] - bank["start_low"][c])
                assert int(s.max() - s.min()) >= span - 3
        np.testing.assert_array_equal(
            qpos.numpy(), bank["qpos"][clip, start].numpy())
        np.testing.assert_array_equal(
            qvel.numpy(), bank["qvel"][clip, start].numpy())


def test_clip_cursor_over_a_float32_episode():
    """The frame each environment tracks is its start plus its control
    steps, counted from its float32 time, up to the step where the clip's
    end ends the episode (120 frames, ``ref_steps`` up to 5: frame 114);
    the autoreset sets it back."""
    env = _env("tracking_ball", dtype=torch.float32, autoreset=True,
               always_init_at_clip_start=True)
    task = env.task._t
    B = 2
    state, _ = env.reset(B, torch.Generator().manual_seed(1))
    action = torch.zeros(B, env.model.nu)

    def cursor(state):
        m = apply_model_diff(env.model, state.model_diff)
        return task._batch_tstep(m, state.data)

    assert cursor(state).tolist() == [0, 0]
    for k in range(1, 115):
        state, ts = env.step(state, action)
        assert cursor(state).tolist() == [k, k], (k, state.data.time)
        want = LAST if k == 114 else MID
        assert ts.step_type.tolist() == [want, want]
        assert ts.discount.tolist() == [1.0, 1.0]
    state, ts = env.step(state, action)
    assert ts.step_type.tolist() == [FIRST, FIRST]
    assert cursor(state).tolist() == [0, 0]
    assert state.data.time.tolist() == [0.0, 0.0]


# -- rewards, clips, walkers -------------------------------------------------------


def _features(rng, B, J=5, E=2, A=3, N=4):
    """Random walker and reference features of B environments."""
    def quat(*shape):
        q = rng.normal(size=shape + (4,))
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    def one():
        return {"position": rng.normal(size=(B, 3)),
                "quaternion": quat(B),
                "joints": rng.normal(size=(B, J)),
                "joints_velocity": rng.normal(size=(B, J)),
                "center_of_mass": 0.1 * rng.normal(size=(B, 3)),
                "end_effectors": 0.1 * rng.normal(size=(B, E, 3)),
                "appendages": 0.1 * rng.normal(size=(B, A, 3)),
                "body_positions": rng.normal(size=(B, N, 3)),
                "body_quaternions": quat(B, N),
                "velocity": rng.normal(size=(B, 3)),
                "angular_velocity": rng.normal(size=(B, 3))}
    return one(), one()


@pytest.mark.parametrize("name", list(trw._REWARD_FNS))
def test_reward_functions_match_jax(name):
    import jax.numpy as jnp

    from dm_control_tpu.locomotion.tasks.reference_pose import rewards as jrw

    assert list(trw._REWARD_FNS) == list(jrw._REWARD_FNS)
    rng = np.random.default_rng(7)
    B = 6
    wf, rf = _features(rng, B)
    err = rng.uniform(0, 0.5, B)
    out = trw.get_reward(name)(
        termination_error=torch.as_tensor(err),
        termination_error_threshold=0.3,
        walker_features={k: torch.as_tensor(v) for k, v in wf.items()},
        reference_features={k: torch.as_tensor(v) for k, v in rf.items()})
    for b in range(B):
        jout = jrw.get_reward(name)(
            termination_error=jnp.asarray(err[b]),
            termination_error_threshold=0.3,
            walker_features={k: jnp.asarray(v[b]) for k, v in wf.items()},
            reference_features={k: jnp.asarray(v[b])
                                for k, v in rf.items()})
        for part in ("reward", "debug", "reward_terms"):
            got, want = getattr(out, part), getattr(jout, part)
            if not isinstance(want, dict):
                got, want = {part: got}, {part: want}
            if want is None or want == {part: None}:
                assert got in (None, {part: None})
                continue
            assert list(got) == list(want), part
            for k in want:
                g = got[k]
                g = g[b] if isinstance(g, torch.Tensor) and g.ndim else g
                np.testing.assert_allclose(np.asarray(g, float),
                                           np.asarray(want[k], float),
                                           rtol=0, atol=1e-12,
                                           err_msg=f"{part} {k}")


@pytest.mark.parametrize("seed", range(4))
def test_synthetic_clip_equals_jax(seed):
    from dm_control_tpu.locomotion.mocap import loader as jloader

    for nq, nv in ((9, 8), (63, 62)):
        ours = tloader.synthetic_walking_trajectory(nq=nq, nv=nv, seed=seed,
                                                    identifier="c")
        theirs = jloader.synthetic_walking_trajectory(nq=nq, nv=nv,
                                                      seed=seed,
                                                      identifier="c")
        assert list(ours.keys()) == list(theirs.keys())
        for k in theirs.keys():
            np.testing.assert_array_equal(ours[k], theirs[k])
        assert (ours.dt, ours.identifier, ours.num_steps) == \
            (theirs.dt, theirs.identifier, theirs.num_steps)


def test_walker_names_match_jax():
    from dm_control_tpu.locomotion.walkers import cmu_humanoid as jcmu
    from dm_control_tpu.locomotion.walkers import jumping_ball as jball

    pairs = ((RollingBallWithHead(), jball.RollingBallWithHead()),
             (CMUHumanoidPositionControlledV2020(),
              jcmu.CMUHumanoidPositionControlledV2020()))
    for ours, theirs in pairs:
        assert ours.name == theirs.name
        for attr in ("root_body_name", "observable_joint_names",
                     "end_effector_body_names"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert getattr(ours, "mocap_tracking_body_names", None) == \
            getattr(theirs, "mocap_tracking_body_names", None)
    cmu = pairs[1][0]
    assert (len(cmu.observable_joint_names),
            len(cmu.mocap_tracking_body_names),
            len(cmu.end_effector_body_names)) == (56, 30, 4)
    # the entity's tree: 56 position actuators, one a joint, in the
    # table's order, each with the 30 ms filter
    acts = cmu.mjcf_model.first("actuator").children
    assert [a.get("joint") for a in acts] == [
        j for j, *_ in cmu_actuator_params.POSITION_ACTUATORS_V2020]
    assert {a.get("dynprm") for a in acts} == {"0.03"}


@pytest.mark.parametrize("asset,nv,candidates,cap", [
    ("tracking_ball", 8, 2, 0), ("tracking_cmu2020", 62, 982, 64)])
def test_model_sizes(asset, nv, candidates, cap):
    """Float32 compacts the CMU humanoid's 982 candidate contacts to 64 a
    condim group, as in the JAX package; float64 keeps them all."""
    from dm_control_torch.physics import collision

    f32 = _env(asset, dtype=torch.float32)
    assert f32.model.nv == nv and f32.model.opt.contact_cap == cap
    assert len(collision.contact_rows_static(f32.model)[0]) == candidates
    assert f32.n_sub_steps == 6
    assert _env(asset).model.opt.contact_cap == 0


def test_refusals(tmp_path):
    """Clips load from an HDF5 file (the loader's flat layout: a group a
    clip); the default device is the card."""
    import h5py

    clips = _task("tracking_ball")._trajectories
    path = str(tmp_path / "clips.h5")
    with h5py.File(path, "w") as f:
        for cid, clip in clips.items():
            for key in ("qpos", "qvel"):
                f.create_dataset(f"{cid}/{key}", data=clip[key])
    task = tracking.MultiClipMocapTracking(RollingBallWithHead(), Floor(),
                                           path)
    assert list(task._trajectories) == list(clips)
    for cid, clip in clips.items():
        for key in ("qpos", "qvel"):
            np.testing.assert_array_equal(task._trajectories[cid][key],
                                          clip[key])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tbatch.compile_task(_task("tracking_ball"), dtype=torch.float32)


@pytest.mark.parametrize("walker,walker_kwargs,floor_kwargs,nv", [
    ("RollingBallWithHead", {"name": "ball"}, {}, 8),
    ("RollingBallWithHead", {"size": 0.2}, {}, 8),
    ("RollingBallWithHead", {}, {"size": (4, 4)}, 8),
    ("JumpingBallWithHead", {}, {}, 9)])
def test_other_walkers_and_arenas_compile(walker, walker_kwargs,
                                          floor_kwargs, nv):
    """A walker or an arena built otherwise than the reference files':
    ``compile_task`` compiles the task's own tree (the JAX compiler's
    model, bit for bit) and steps it."""
    import jax.numpy as jnp

    from dm_control_torch.locomotion.walkers import jumping_ball as tball
    from dm_control_tpu.locomotion.arenas import floors as jfloors
    from dm_control_tpu.locomotion.tasks.reference_pose import (
        tracking as jtracking,
    )
    from dm_control_tpu.locomotion.walkers import jumping_ball as jball
    from dm_control_tpu.mjcf import compiler as jcompiler

    clips = {"c": tloader.synthetic_walking_trajectory(
        nq=nv + 1, nv=nv, num_steps=40)}
    task = tracking.MultiClipMocapTracking(
        getattr(tball, walker)(**walker_kwargs), Floor(**floor_kwargs),
        clips)
    env = tbatch.compile_task(task, device="cpu", dtype=torch.float64)
    jtask = jtracking.MultiClipMocapTracking(
        getattr(jball, walker)(**walker_kwargs),
        jfloors.Floor(**floor_kwargs), clips)
    jroot = jtask.root_entity.mjcf_model
    jroot.add("option").attrib["timestep"] = str(jtask.physics_timestep)
    model_io_tests._assert_same(
        tcompiler._Compiler(task.root_entity.mjcf_model).compile(),
        model_io.from_jax_model(jcompiler._Compiler(
            jroot, jnp.float64).compile()))
    assert env.model.nv == nv
    state, _ = env.reset(2, torch.Generator().manual_seed(0))
    state, ts = env.step(state, torch.zeros(2, env.model.nu,
                                            dtype=torch.float64))
    assert bool(torch.isfinite(ts.reward).all())
    assert ts.observation["walker/joints_pos"].shape == (2, nv - 6)


# -- slow: the checked-in files against fresh JAX runs ---------------------------


@pytest.mark.slow
@pytest.mark.parametrize("asset", ASSETS)
def test_golden_file_equals_what_jax_gives_now(asset):
    name = f"locomotion_{asset}"
    gold = golden(name)
    fresh = export_tool().make_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("asset", ASSETS)
def test_checked_in_asset_equals_a_fresh_export(asset):
    model_io_tests._assert_same(
        model_io.load(export_tool().asset_path(asset), "cpu", torch.float64),
        model_io.from_jax_model(jax_model(asset)))
