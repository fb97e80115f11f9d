"""The port's locomotion tasks on composer's host path against the JAX
package's, in float64 on the CPU: ``soccer.load`` and
``MultiClipMocapTracking`` -> the entities' MJCF trees ->
``mjcf.compile_model`` -> ``composer.Environment``.

- The entity trees compile to the JAX compiler's model bit for bit
  (``_Compiler(root).compile()``, before ``set_const``): soccer 1, 2 and 3
  a side, walker contacts off, a ``RandomizedPitch`` episode's tree after
  the same draws, and both tracking walkers on a ``Floor``.  The four
  batched tasks, compiled by ``load_batch`` and ``compile_task`` with
  nothing loaded from ``locomotion/assets/``, equal their reference files
  (the JAX compiler's output): the compiler's fields exactly, the
  ``set_const`` fields within 1e-10 of each field's largest entry.
- A host episode of each of four environments (``tools/export_torch_
  assets.py loco_env_goldens``: ``soccer.load(team_size=1)`` on its
  randomized pitch, two a side on a fixed (12, 9) pitch with the field
  box, ball and CMU 2020 tracking) replayed one control step at a time
  from the recorded JAX state (``rl/golden.py``): the reset's draws
  exactly (qpos and the drawn pitch's geom sizes), every step within the
  golden gate.
- Soccer's host hooks against its batched hooks at shared states, a goal
  forced into each net (``tests/test_batch_host_parity.py``); tracking's
  host reward, termination and observations against its batched hooks.
- The possession tracker against the JAX ball's over one sequence of
  hits, and fed from live contacts; every enabled observable key against
  the JAX task's; a goal ends ``Task``'s episode and re-kicks off in
  ``MultiturnTask``'s; the randomized pitch recompiles every episode.
- What the port does not build raises (ANT and HUMANOID players on the
  batched path, tracking cameras); ``load`` builds ANT and HUMANOID
  matches; the default device is the card.

JAX environments are built with ``composer.Environment`` replaced (no
MJCF compile, nothing jitted).  Marked ``slow``: each host golden equals
a fresh JAX episode.
"""

import types

import numpy as np
import pytest
import torch

import test_torch_model_io as model_io_tests
import test_torch_tracking as ttracking
from _torch_helpers import export_tool
from dm_control_torch import composer as tcomposer
from dm_control_torch.composer import batch as tbatch
from dm_control_torch.locomotion import soccer as tsoccer
from dm_control_torch.locomotion import walkers as twalkers
from dm_control_torch.locomotion.walkers import cmu_actuator_params
from dm_control_torch.mjcf import compiler as tcompiler
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import model_io
from dm_control_torch.rl import golden as tgolden

GOLDENS = export_tool().LOCO_ENV_GOLDENS
#: reference file -> how the port builds its batched task
ASSETS = ("soccer_1v1", "soccer_2v2", "tracking_ball", "tracking_cmu2020")
SET_CONST_REL = 1e-10
#: the soccer trees held to the JAX package's: ``soccer.load`` arguments,
#: and whether the pitch draws an episode first
TREES = {"soccer_1v1": ({"team_size": 1}, False),
         "soccer_2v2": ({"team_size": 2}, False),
         "soccer_3v3": ({"team_size": 3}, False),
         "soccer_no_walker_contacts": ({"disable_walker_contacts": True},
                                       False),
         "soccer_randomized_episode": ({"team_size": 2}, True)}
FIXED = {"team_size": 1, "pitch_size": (12, 9), "enable_field_box": True}


def _jax_env(factory, *args, **kwargs):
    """A JAX entry point's environment with ``composer.Environment``
    replaced (no MJCF compile): its task and keyword arguments."""
    from dm_control_tpu import composer as jcomposer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcomposer, "Environment",
                   lambda task, **kw: types.SimpleNamespace(task=task, **kw))
        return factory(*args, **kwargs)


def _jax_soccer(**kwargs):
    from dm_control_tpu.locomotion import soccer as jsoccer

    return _jax_env(jsoccer.load, **kwargs)


def _timestep(root, task):
    opt = root.first("option")
    if opt is None:
        opt = root.add("option")
    opt.attrib["timestep"] = str(task.physics_timestep)
    return root


def _draw_episode(task, seed):
    """The environment's MJCF draws of one reset: the task's, then every
    entity's, from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    task.initialize_episode_mjcf(rs)
    for entity in task.root_entity.iter_entities():
        entity.initialize_episode_mjcf(rs)
    return rs


def _golden(name):
    with np.load(export_tool().loco_env_golden_path(name),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _port_env(name):
    """The port's environment of a host golden, as ``loco_env`` builds the
    JAX one."""
    if name in tgolden.SOCCER_EPISODES:
        return tsoccer.load(**tgolden.SOCCER_EPISODES[name], device="cpu")
    seed = export_tool().LOCO_ENV_SEED
    return tcomposer.Environment(
        ttracking._task(name),
        time_limit=export_tool().TRACKING_TIME_LIMITS[name],
        random_state=seed, device="cpu")


def _enabled(task):
    return [k for k, o in task.observables.items() if o.enabled]


# -- trees ---------------------------------------------------------------------


@pytest.mark.parametrize("tree", list(TREES) + ["tracking_ball",
                                                "tracking_cmu2020"])
def test_tree_compiles_like_jax(tree):
    """The port's compiler on the port's tree equals the JAX compiler on
    the JAX task's tree, every leaf bit for bit."""
    import jax.numpy as jnp

    from dm_control_tpu.mjcf import compiler as jcompiler

    if tree.startswith("tracking"):
        task, jtask = ttracking._task(tree), export_tool().locomotion_task(
            tree)
    else:
        kwargs, draw = TREES[tree]
        task = tsoccer.load(device="cpu", **kwargs).task
        jtask = _jax_soccer(**kwargs).task
        if draw:
            rs, jrs = _draw_episode(task, 3), _draw_episode(jtask, 3)
            assert task.arena.size == jtask.arena.size != (48, 36)
            np.testing.assert_array_equal(rs.get_state()[1],
                                          jrs.get_state()[1])
    model = tcompiler._Compiler(
        _timestep(task.root_entity.mjcf_model, task)).compile()
    model_io_tests._assert_same(model, model_io.from_jax_model(
        jcompiler._Compiler(_timestep(jtask.root_entity.mjcf_model, jtask),
                            jnp.float64).compile()))
    nv = {"soccer_1v1": 22, "soccer_2v2": 38, "soccer_3v3": 54,
          "tracking_ball": 8, "tracking_cmu2020": 62}
    assert model.nv == nv.get(tree, 38)


@pytest.mark.parametrize("asset", ASSETS)
def test_batched_task_compiles_the_reference_model(asset, monkeypatch):
    """``load_batch`` and ``compile_task`` compile the task's tree, reading
    no file: its model against the reference file, compiler fields
    equal, ``set_const`` fields within 1e-10 of each field's largest
    entry."""
    reference = model_io.load(export_tool().asset_path(asset), "cpu",
                              torch.float64)

    def no_file(*args, **kwargs):
        raise AssertionError("a model file was read")

    monkeypatch.setattr(model_io, "load", no_file)
    if asset.startswith("soccer"):
        env = tsoccer.load_batch(team_size=int(asset[-1]), device="cpu",
                                 dtype=torch.float64)
    else:
        env = ttracking._env(asset)
    devs = model_io.deviations(env.model, reference)
    for k, rel in devs.items():
        assert rel <= (SET_CONST_REL if k in model_io.SET_CONST_FIELDS
                       else 0), (k, rel)


# -- host episodes against the JAX package's -----------------------------------


@pytest.mark.parametrize("name", GOLDENS)
def test_host_episode_matches_golden(name):
    """The recorded JAX episode replayed one control step at a time: the
    reset's draws exactly (qpos, the drawn pitch's geom sizes), every
    timestep within the golden gate (``-s`` prints the figures)."""
    gold = _golden(name)
    env = _port_env(name)
    errs = tgolden.host_episode_errors(env, gold)
    figures, ok = tgolden.episode_gate(errs, gold, name)
    print(f"\n{name}: " + ", ".join(f"t{t} rest {a:.3e} qacc_warmstart "
                                    f"{b:.3e}" for t, (a, b) in
                                    enumerate(figures)))
    assert ok, figures
    assert errs[0]["step_qpos"] == 0.0
    assert errs[0]["model_geom_size"] == errs[0]["model_geom_rbound"] == 0.0
    assert len(errs) == export_tool().LOCO_ENV_STEPS + 1
    if name == "soccer_1v1":  # a drawn pitch, compiled for the episode
        m = env.physics.model
        size = env.task.arena.size
        assert (32 < size[0] < 48) and (24 < size[1] < 36)
        np.testing.assert_array_equal(
            m.geom_size[m.names.geom["field"], :2].numpy(), size)


@pytest.mark.slow
@pytest.mark.parametrize("name", GOLDENS)
def test_host_golden_equals_what_jax_gives_now(name):
    gold = _golden(name)
    fresh = export_tool().make_loco_env_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


# -- host vs batched -----------------------------------------------------------


def _batched_at(benv, state):
    """(observation, reward, terminate, discount) of the batched hooks at
    ``state``."""
    from dm_control_torch.rl.control import apply_model_diff

    m = apply_model_diff(benv.model, state.model_diff)
    d = tengine.forward(m, benv._unstrip(state.data))
    terminate, discount = benv.task.termination(m, d)
    return (benv.task.observation(m, d), benv.task.reward(m, d), terminate,
            discount)


def _host_at(env, qpos, qvel):
    physics = env.physics
    physics.set_data(qpos=qpos, qvel=qvel)
    physics.forward()
    return physics


_SHARED_OBS = ("ball_ego_position", "ball_ego_linear_velocity",
               "ball_ego_angular_velocity", "team_goal_mid",
               "opponent_goal_mid", "others_ego_position",
               "others_ego_linear_velocity", "teammate_mask")


def test_soccer_host_and_batched_hooks_agree():
    """The host hooks (goal detectors, rewards, discount, termination, the
    per-player observables) against the batched hooks at a batched
    reset's environment 0, after three batched steps, and with the ball
    forced into the home and then the away goal."""
    host = tsoccer.load(device="cpu", **FIXED)
    host.reset()
    task = host.task
    benv = tsoccer.load_batch(team_size=1, device="cpu",
                              dtype=torch.float64)
    state, _ = benv.reset(2, torch.Generator().manual_seed(0))
    lay = benv.task._t._batch_layout(benv.model)
    a = lay["ball_qadr"]
    cases = []
    for _ in range(3):
        state, _ = benv.step(state, torch.zeros(2, benv.model.nu,
                                                dtype=torch.float64))
    qpos, qvel = state.data.qpos[0].numpy(), state.data.qvel[0].numpy()
    cases.append((qpos, qvel, None))
    for goal, scorer in ((task.arena.home_goal, tsoccer.Team.AWAY),
                         (task.arena.away_goal, tsoccer.Team.HOME)):
        q = qpos.copy()
        q[a:a + 3] = goal.mid
        cases.append((q, qvel, scorer))
    for q, v, scorer in cases:
        s = state.replace(data=state.data.replace(
            qpos=torch.as_tensor(np.stack([q, q])),
            qvel=torch.as_tensor(np.stack([v, v]))))
        obs, reward, terminate, discount = _batched_at(benv, s)
        physics = _host_at(host, q, v)
        task.arena.update_detection(physics)
        assert task.arena.detected_goal() == scorer
        np.testing.assert_array_equal(
            np.asarray(task.get_reward(physics), float), reward[0].numpy())
        assert bool(terminate[0]) == task.should_terminate_episode(physics)
        assert float(discount[0]) == float(task.get_discount(physics))
        host_obs = {k: np.asarray(o(physics)) for k, o in
                    task.observables.items() if o.enabled}
        for i, p in enumerate(task.players):
            for k in _SHARED_OBS:
                np.testing.assert_allclose(
                    host_obs[f"player_{i}/{k}"],
                    obs[f"player_{i}/{k}"][0].numpy(), rtol=0, atol=1e-12,
                    err_msg=k)
            for k in ("field_front_left", "field_back_right"):
                np.testing.assert_allclose(
                    host_obs[f"player_{i}/{k}"][:2],
                    obs[f"player_{i}/{k}"][0].numpy(), rtol=0, atol=1e-12)
            for k in ("joints_pos", "joints_vel"):
                np.testing.assert_array_equal(
                    host_obs[f"{p.walker.name}/{k}"],
                    obs[f"player_{i}/{k}"][0].numpy())
            np.testing.assert_allclose(
                host_obs[f"player_{i}/stats_vel_to_ball"],
                float(obs[f"player_{i}/stats_vel_to_ball"][0]), rtol=0,
                atol=1e-6)


def test_tracking_host_and_batched_hooks_agree():
    """Ball tracking's host reward, termination, discount and
    observations against its batched hooks at the host episode's states
    (each brought up to date by a forward, as the batched path reads
    them), the batched environment set to the host's clip and start
    frame."""
    from dm_control_torch.rl.control import apply_model_diff

    task = ttracking._task("tracking_ball")
    host = tcomposer.Environment(task, time_limit=10.0, random_state=4,
                                 device="cpu")
    host.reset()
    benv = tbatch.compile_task(task, device="cpu", dtype=torch.float64,
                               time_limit=10.0)
    rng = np.random.RandomState(0)
    for k in range(4):
        if k:
            host.step(rng.uniform(-1, 1, 2))
        physics = host.physics
        physics.forward()
        task._update_error(physics)
        d = physics._data
        diff = {"_clip": torch.tensor([task._clip_index], dtype=torch.int32),
                "_start": torch.tensor([task._start_step],
                                       dtype=torch.int32)}
        state = benv.from_state(d.qpos, d.qvel, d.qacc_warmstart, d.time,
                                generator=torch.Generator().manual_seed(0),
                                model_diff=diff, act=d.act)
        obs, reward, terminate, discount = _batched_at(benv, state)
        assert int(task._batch_tstep(apply_model_diff(benv.model, diff),
                                     d)[0]) == task._time_step
        assert task.get_reward(physics) == pytest.approx(float(reward[0]),
                                                         abs=1e-12)
        assert bool(terminate[0]) == task.should_terminate_episode(physics)
        assert float(discount[0]) == task.get_discount(physics)
        host_obs = {key: np.asarray(o(physics)) for key, o in
                    task.observables.items() if o.enabled}
        shared = [key for key in host_obs if key in obs]
        assert len(shared) == 8
        for key in shared:
            np.testing.assert_allclose(host_obs[key], obs[key][0].numpy(),
                                       rtol=0, atol=1e-12, err_msg=key)
        for key in ("joints_pos", "joints_vel"):
            np.testing.assert_array_equal(
                host_obs[f"ball_walker/{key}"],
                obs[f"walker/{key}"][0].numpy())
    assert task._time_step == task._start_step + 3
    assert task.last_reward_terms is not None
    assert all(np.isfinite(v) for v in task.last_reward_terms.values())


# -- the ball's possession tracker ----------------------------------------------


def test_possession_tracker_matches_jax():
    """One sequence of hits, by teammates and opponents with positions,
    through the port's ball and the JAX ball: the same flags, last hitter
    and distances after every hit (``tests/test_locomotion.py``)."""
    from dm_control_tpu.locomotion.soccer import soccer_ball as jball

    ours, theirs = tsoccer.SoccerBall(), jball.SoccerBall()
    players = [types.SimpleNamespace(team=t) for t in ("home", "home",
                                                        "away")]
    seq = ((0, (0, 0, 0)), (0, (1, 0, 0)), (1, (4, 3, 0)), (2, (4, 3, 0)),
           (2, None), (0, (10, 3, 0)))
    for ball in (ours, theirs):
        ball.initialize_entity_trackers()
    for who, pos in seq:
        for ball in (ours, theirs):
            last = ball.last_hit
            ball.clear_step_flags()
            ball.update_hit(players[who], last is not None
                            and last.team == players[who].team,
                            position=pos)
        assert (ours.hit, ours.repossessed, ours.intercepted) == \
            (theirs.hit, theirs.repossessed, theirs.intercepted)
        assert ours.last_hit is theirs.last_hit is players[who]
        assert ours.dist_between_last_hits == theirs.dist_between_last_hits
    assert ours.dist_between_last_hits == pytest.approx(6.0)
    ours.clear_step_flags()
    assert not (ours.hit or ours.repossessed or ours.intercepted)
    assert ours.last_hit is players[0]


def test_possession_from_live_contacts():
    """The task's contact scan feeds the tracker: the ball set in home0's
    head is home0's, then in away0's an interception, seen in
    ``stats_ball_events`` ([last hitter is me, hit, repossessed,
    intercepted])."""
    env = tsoccer.load(device="cpu", random_state=0, **FIXED)
    env.reset()
    task, physics = env.task, env.physics
    home, away = task.players
    for player, events in ((home, ([1, 1, 1, 0], [0, 1, 1, 0])),
                           (away, ([0, 1, 1, 1], [1, 1, 1, 1]))):
        task.ball.set_pose(physics, player.walker.root_xpos(physics))
        physics.forward()
        task._update_ball_contacts(physics)
        assert task.ball.hit and task.ball.last_hit is player
        obs = task.observables
        np.testing.assert_array_equal(
            obs["player_0/stats_ball_events"](physics), events[0])
        np.testing.assert_array_equal(
            obs["player_1/stats_ball_events"](physics), events[1])
    # far from everyone: no hit, the last hitter stays
    task.ball.set_pose(physics, [0.0, 0.0, 5.0])
    physics.forward()
    task._update_ball_contacts(physics)
    assert not task.ball.hit and task.ball.last_hit is away


# -- the environment -----------------------------------------------------------


@pytest.mark.parametrize("team_size", [1, 2])
def test_observable_keys_match_jax(team_size):
    """The enabled observables of ``soccer.load`` (walkers' proprioception,
    then the players', teammates and opponents among them) in the JAX
    task's order; with the interception adder too; and tracking's."""
    assert _enabled(tsoccer.load(team_size=team_size, device="cpu").task) \
        == _enabled(_jax_soccer(team_size=team_size).task)
    from dm_control_tpu.locomotion.soccer import loader as jloader
    from dm_control_tpu.locomotion.soccer import observables as jobs
    from dm_control_tpu.locomotion.soccer import pitch as jpitch
    from dm_control_tpu.locomotion.soccer import task as jtask

    def adders(lib):
        return lib.MultiObservablesAdder([lib.CoreObservablesAdder(),
                                          lib.InterceptionObservablesAdder()])

    ours = tsoccer.Task(tsoccer.task.standard_players(team_size),
                        tsoccer.Pitch(), observables=adders(tsoccer))
    theirs = jtask.Task(jloader._make_players(team_size,
                                              jloader.WalkerType.BOXHEAD),
                        jpitch.Pitch(), observables=adders(jobs))
    keys = _enabled(ours)
    assert keys == _enabled(theirs)
    assert "player_0/stats_i_received_ball_10m" in keys
    if team_size == 2:
        assert "player_0/teammate_0_ego_position" in keys
    for asset in ("tracking_ball", "tracking_cmu2020"):
        assert _enabled(ttracking._task(asset)) == _enabled(
            export_tool().locomotion_task(asset))


@pytest.mark.parametrize("terminate_on_goal", [True, False])
def test_goal_ends_or_rekicks_the_episode(terminate_on_goal):
    """The ball set at rest inside the away goal: the home player gets +1
    and the away player -1 on the next step; ``Task`` ends the episode
    with discount 0, ``MultiturnTask`` plays on with discount 1 and the
    ball kicked off again inside the spawn box."""
    env = tsoccer.load(device="cpu", terminate_on_goal=terminate_on_goal,
                       random_state=0, **FIXED)
    env.reset()
    task = env.task
    task.ball.set_pose(env.physics, task.arena.away_goal.mid)
    env.physics.forward()
    ts = env.step(np.zeros(env.action_spec().shape))
    np.testing.assert_array_equal(ts.reward, [1.0, -1.0])
    assert task.scores == {tsoccer.Team.HOME: 1, tsoccer.Team.AWAY: 0}
    if terminate_on_goal:
        assert ts.last() and ts.discount == 0.0
    else:
        assert ts.mid() and ts.discount == 1.0
        x, y, _ = task.ball.position(env.physics)
        assert abs(x) <= 0.6 * 12 and abs(y) <= 0.6 * 9
        ts = env.step(np.zeros(env.action_spec().shape))
        np.testing.assert_array_equal(ts.reward, [0.0, 0.0])


def test_randomized_pitch_recompiles_every_episode():
    """Each reset draws a pitch and compiles it: a new model whose ground,
    walls and goal sites have the drawn size, with a cache of its own,
    stepped with finite observations; per-player action specs split the
    action."""
    env = tsoccer.load(team_size=1, random_state=5, device="cpu")
    models, sizes = [], []
    for _ in range(2):
        ts = env.reset()
        m = env.physics.model
        arena = env.task.arena
        models.append(m)
        sizes.append(arena.size)
        np.testing.assert_array_equal(
            m.geom_size[m.names.geom["field"], :2].numpy(), arena.size)
        sx = arena.size[0]
        assert float(m.geom_pos[m.names.geom["wall_2"], 0]) == sx
        gx = min(tsoccer.pitch._SIDE_WIDTH / 2, sx / 12.0)
        assert float(m.site_pos[m.names.site["away_goal"], 0]) == sx - gx
        specs = env.task.action_spec_per_player(env.physics)
        assert [s.shape for s in specs] == [(m.nu // 2,)] * 2
        ts = env.step([s.minimum for s in specs])
        assert all(np.all(np.isfinite(v)) for v in ts.observation.values())
    assert models[0] is not models[1] and sizes[0] != sizes[1]
    assert models[1]._cache is not models[0]._cache


def test_cmu_tracking_runs():
    """The CMU 2020 humanoid tracks its clip through
    ``composer.Environment``: a reset on the drawn clip's frame, control
    steps with finite rewards, the 56 position actuators' controls from
    ``cmu_pose_to_actuation``."""
    task = ttracking._task("tracking_cmu2020")
    env = tcomposer.Environment(task, time_limit=30.0, random_state=0,
                                device="cpu")
    ts = env.reset()
    frame = task._clip.get_timestep_data(task._time_step)
    np.testing.assert_array_equal(env.physics.data.qpos.numpy(),
                                  frame["qpos"])
    walker = task._walker
    assert ts.observation["walker/joints_pos"].shape == (56,)
    assert walker.observable_joint_names == tuple(
        cmu_actuator_params.CMU_MOCAP_JOINTS)
    for _ in range(2):
        pose = task._clip.get_timestep_data(task._time_step + 1)["qpos"][7:]
        action = walker.cmu_pose_to_actuation(pose)
        ts = env.step(np.clip(action, -1, 1))
        assert ts.mid() and np.isfinite(ts.reward) and ts.reward > 0
    assert task._time_step == task._start_step + 2


# -- refusals and devices --------------------------------------------------------


def test_refusals_and_default_device():
    for walker_type, cls in ((tsoccer.WalkerType.ANT, twalkers.Ant),
                             ("humanoid", tsoccer.Humanoid)):
        env = tsoccer.load(team_size=1, walker_type=walker_type,
                           device="cpu")
        assert [type(p.walker) for p in env.task.players] == [cls, cls]
        with pytest.raises(NotImplementedError, match="BoxHead"):
            tsoccer.load_batch(walker_type=walker_type, device="cpu",
                               dtype=torch.float64)
    # tracking cameras are taken (they render since rendering was ported)
    cam = tsoccer.MultiplayerTrackingCamera(2.0, 1.0, 0.5, width=8,
                                            height=6)
    task = tsoccer.Task(tsoccer.task.standard_players(1), tsoccer.Pitch(),
                        tracking_cameras=(cam,))
    assert task._tracking_cameras == (cam,) and cam.camera is None
    with pytest.raises(ValueError, match="team_size"):
        tsoccer.load(team_size=12, device="cpu")
    env = tsoccer.load(team_size=1, device="cpu", dtype=torch.float32)
    assert env.physics.model.dtype == torch.float32
    assert env.physics.model.device.type == "cpu"
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tsoccer.load()
        with pytest.raises(RuntimeError, match="CUDA"):
            tcomposer.Environment(ttracking._task("tracking_ball"))
