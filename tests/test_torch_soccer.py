"""The port's batched soccer path against the JAX package, in float64 on
the CPU: ``locomotion.soccer.load_batch`` -> the soccer task's batched
hooks -> ``BatchEnv.reset/step`` with one reward per player.

- From each soccer golden (``tools/export_torch_assets.py soccer``: 1 and
  2 a side) one ``BatchEnv.step`` passes ``rl/golden.py``'s gate.  In the
  goldens' later states environment 0's ball rolls into the away goal and
  environment 1's into the home goal during the step: the recorded
  per-player rewards (+1 for the scoring team, -1 for the other),
  discount 0 and ``LAST`` are JAX's.
- ``BatchEnv`` serves a (B, 4) reward with a (B,) discount and step type
  through reset, a goal, the autoreset after it and a diverged
  environment.
- The task's observation, reward and termination equal the JAX task's
  batched hooks (vmapped) to 1e-10 on the goldens' states, goals among
  them; its ``batch_init`` equals the JAX task's on numpy draws to 1e-12;
  the port's own draws stay in the spawn box.
- The pitch's goals and field and BoxHead's names equal the JAX ones;
  the matches the JAX ``load_batch`` builds beyond the reference files
  (3 a side, a (16, 12) pitch, walker contacts off) compile to its model
  and step; what the port cannot build raises and names the ROADMAP
  item.

Marked ``slow``: each golden file equals a fresh JAX run, and each asset
a fresh export.
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
from dm_control_torch.locomotion import soccer as tsoccer
from dm_control_torch.mjcf import compiler as tcompiler
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import model_io
from dm_control_torch.rl.control import FIRST, LAST, MID, RandomContext
from dm_control_torch.rl.golden import start_state

#: asset -> its team size
ASSETS = {"soccer_1v1": 1, "soccer_2v2": 2}
ATOL = 1e-10


def _env(asset, autoreset=False):
    return tsoccer.load_batch(team_size=ASSETS[asset], device="cpu",
                              dtype=torch.float64, autoreset=autoreset)


def _jax_task(asset):
    """The JAX package's soccer task of an asset, as its ``load_batch``
    builds it (entities only: no MJCF compile)."""
    return export_tool().locomotion_task(asset)


# -- the goldens ----------------------------------------------------------------


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("asset", ASSETS)
def test_batch_env_step_matches_golden(asset, prefix):
    assert_step_matches_golden(_env(asset), golden(f"locomotion_{asset}"),
                               prefix)


@pytest.mark.parametrize("asset", ASSETS)
def test_golden_goal_step(asset):
    """The recorded goals: the port's rewards equal JAX's by value (JAX
    gives -0.0 to the away players where no goal is scored), the scoring
    environments end with discount 0 and the others play on with the
    ball on the floor."""
    gold = golden(f"locomotion_{asset}")
    env = _env(asset)
    n = ASSETS[asset]
    home = np.array([1.0] * n + [-1.0] * n)
    state, ts = env.step(start_state(env, gold, "contact"), torch.as_tensor(
        gold["contact_actions"]))
    want = np.stack([home, -home, 0 * home, 0 * home])
    np.testing.assert_array_equal(ts.reward.numpy(), want)
    np.testing.assert_array_equal(gold["contact_reward"], want)
    np.testing.assert_array_equal(ts.discount.numpy(), [0.0, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(ts.step_type.numpy(),
                                  [LAST, LAST, MID, MID])
    np.testing.assert_array_equal(gold["contact_step_type"],
                                  [LAST, LAST, MID, MID])
    # each scoring ball inside its goal by more than float32's rounding
    ball = state.data.qpos[:, 0]
    assert float(ball[0]) > 10.05 and float(ball[1]) < -10.05
    # the other balls landed: the ball-floor contact carries force
    m = env.model
    d = tengine.forward(m, env._unstrip(state.data))
    floor = m.names.geom["field"]
    ball_geom = next(g for name, g in m.names.geom.items()
                     if name.startswith("soccer_ball"))
    pair = [c for c, (g1, g2) in enumerate(zip(d.contact.geom1,
                                               d.contact.geom2))
            if {g1, g2} == {floor, ball_geom}]
    assert bool((d.contact.dist[2:, pair] < 0).any(-1).all())


# -- per-player rewards in BatchEnv -------------------------------------------------


def test_batch_env_serves_per_player_rewards():
    """(B, 4) rewards with (B,) discounts and step types through reset, a
    goal, the autoreset after it, and a diverged environment."""
    gold = golden("locomotion_soccer_2v2")
    env = _env("soccer_2v2", autoreset=True)
    B = 4
    state, ts = env.reset(B, torch.Generator().manual_seed(0))
    assert ts.reward.shape == (B, 4) and not bool(ts.reward.any())
    assert ts.discount.shape == (B,) and ts.step_type.shape == (B,)
    np.testing.assert_array_equal(ts.discount.numpy(), np.ones(B))
    np.testing.assert_array_equal(ts.step_type.numpy(), [FIRST] * B)
    # a goal in environments 0 and 1; environment 3 diverges
    state = start_state(env, gold, "contact")
    qvel = state.data.qvel.clone()
    qvel[3, 20] = float("nan")
    state = state.replace(data=state.data.replace(qvel=qvel))
    action = torch.as_tensor(gold["contact_actions"])
    state, ts = env.step(state, action)
    assert ts.reward.shape == (B, 4) and ts.discount.shape == (B,)
    np.testing.assert_array_equal(ts.reward.numpy(), [
        [1, 1, -1, -1], [-1, -1, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0]])
    np.testing.assert_array_equal(ts.discount.numpy(), [0.0, 0.0, 1.0, 0.0])
    np.testing.assert_array_equal(ts.step_type.numpy(),
                                  [LAST, LAST, MID, LAST])
    # the autoreset: new episodes in 0, 1 and 3, environment 2 plays on
    state, ts = env.step(state, action)
    assert ts.reward.shape == (B, 4) and ts.discount.shape == (B,)
    np.testing.assert_array_equal(ts.step_type.numpy(),
                                  [FIRST, FIRST, MID, FIRST])
    assert not bool(ts.reward[[0, 1, 3]].any())
    np.testing.assert_array_equal(ts.discount.numpy(), np.ones(B))
    np.testing.assert_array_equal(state.step_count.numpy(), [0, 0, 2, 0])
    assert bool(torch.isfinite(state.data.qvel).all())


# -- the task's hooks against the JAX task's -------------------------------------


def _states(asset):
    """(env, qpos, qvel, model_diff, ctrl): the golden's start and stepped
    states, float64 tensors; the stepped later states hold the goals."""
    gold = golden(f"locomotion_{asset}")
    env = _env(asset)
    qpos = torch.as_tensor(np.concatenate(
        [gold[f"{tag}_qpos"] for p in PREFIXES for tag in (p, f"{p}_step")]))
    qvel = torch.as_tensor(np.concatenate(
        [gold[f"{tag}_qvel"] for p in PREFIXES for tag in (p, f"{p}_step")]))
    n = qpos.shape[0]
    ctrl = torch.as_tensor(np.random.default_rng(n).uniform(
        -1, 1, (n, env.model.nu)))
    return env, qpos, qvel, {}, ctrl


@pytest.mark.parametrize("asset", ASSETS)
def test_task_hooks_match_jax(asset):
    from dm_control_tpu.composer.batch import _PureTaskAdapter

    env, qpos, qvel, diff, ctrl = _states(asset)
    n = qpos.shape[0]
    (obs, reward, terminate, discount), d = tasks._port(env, qpos, qvel,
                                                        diff, ctrl)
    jenv = types.SimpleNamespace(model=jax_model_from_asset(asset),
                                 task=_PureTaskAdapter(_jax_task(asset)))
    jobs, jreward, jterminate, jdiscount = tasks._jax(
        None, None, qpos, qvel, diff, ctrl, env=jenv, port_data=d)
    assert list(obs) == list(jobs)
    for k, v in obs.items():
        assert v.shape[0] == n
        np.testing.assert_allclose(
            v.numpy().reshape(n, -1), np.asarray(jobs[k]).reshape(n, -1),
            rtol=0, atol=ATOL, err_msg=k)
    assert reward.shape == (n, 2 * ASSETS[asset])
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
    np.testing.assert_array_equal(terminate.numpy(), np.asarray(jterminate))
    np.testing.assert_array_equal(discount.numpy(), np.asarray(jdiscount))
    # the states hold both goals, and the players see the ball move
    assert bool((reward[:, 0] == 1).any() and (reward[:, 0] == -1).any())
    assert float(obs["player_0/stats_vel_to_ball"].abs().max()) > 1e-3


@pytest.mark.parametrize("asset", ASSETS)
def test_task_init_matches_jax(asset):
    """``batch_init`` of both packages on numpy draws of the same seeds:
    the same calls in the same order, the same starts to 1e-12."""
    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_tpu.rl.control import RandomContext as JRandomContext

    env = _env(asset)
    m, task = env.model, env.task._t
    jm = jax_model_from_asset(asset)
    jtask = _jax_task(asset)
    for seed in range(3):
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
        np.testing.assert_allclose(qpos[0].numpy(), np.asarray(jqpos),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(qvel[0].numpy(), np.asarray(jqvel))
        assert diff == {} and jdiff == {}
        np.testing.assert_array_equal(ours.get_state()[1],
                                      theirs.get_state()[1])
        assert ours.get_state()[2] == theirs.get_state()[2]


@pytest.mark.parametrize("asset", ASSETS)
def test_init_draws_stay_in_the_spawn_box(asset):
    """The port's draws (a torch generator) over B = 4096: the ball and
    every player in the box of 0.6 of the pitch, spread over most of it,
    the ball at 0.5 m, the yaws over most of [-pi, pi]."""
    env = _env(asset)
    m, task = env.model, env.task._t
    B = 4096
    qpos, _, _ = task.batch_init(
        m, m.qpos0.expand(B, m.nq), torch.zeros(B, m.nv, dtype=m.dtype),
        RandomContext(torch.Generator().manual_seed(5), B, m.dtype), {})
    lay = task._batch_layout(m)
    box = torch.tensor([7.2, 5.4], dtype=m.dtype)
    a = lay["ball_qadr"]
    xys = [qpos[:, a:a + 2]] + [qpos[:, [qx, qy]]
                                for qx, qy, _ in lay["root_q"]]
    for xy in xys:
        assert bool((xy.abs() <= box).all())
        assert bool((xy.amax(0) - xy.amin(0) > 0.95 * 2 * box).all())
    assert bool((qpos[:, a + 2] == 0.5).all())
    for steer in lay["steer_q"]:
        yaw = qpos[:, steer]
        assert bool((yaw.abs() <= np.pi).all())
        assert float(yaw.max() - yaw.min()) > 0.95 * 2 * np.pi


# -- names, geometry and refusals ----------------------------------------------------


def test_pitch_and_boxhead_match_jax():
    from dm_control_tpu.locomotion.soccer import boxhead as jboxhead
    from dm_control_tpu.locomotion.soccer import pitch as jpitch

    for kwargs in ({}, {"size": (20, 15)},
                   {"goal_size": jpitch.MINI_FOOTBALL_GOAL_SIZE}):
        ours, theirs = tsoccer.Pitch(**kwargs), jpitch.Pitch(**kwargs)
        for region in ("home_goal", "away_goal", "field"):
            a, b = getattr(ours, region), getattr(theirs, region)
            np.testing.assert_array_equal(a.lower, b.lower)
            np.testing.assert_array_equal(a.upper, b.upper)
            np.testing.assert_array_equal(a.mid, b.mid)
        assert ours.home_goal.team == tsoccer.Team.HOME
        assert ours.away_goal.detect(ours.away_goal.upper)
    ours, theirs = tsoccer.RandomizedPitch(), jpitch.RandomizedPitch()
    np.testing.assert_array_equal(ours.field.upper, theirs.field.upper)
    b, jb = tsoccer.BoxHead(name="home0"), jboxhead.BoxHead(name="home0")
    assert b.root_body_name == jb.root_body_name
    assert b.observable_joint_names == jb.observable_joint_names
    assert tsoccer.MINI_FOOTBALL_GOAL_SIZE == jpitch.MINI_FOOTBALL_GOAL_SIZE


def test_refusals():
    """What the port does not build raises: the batched path refuses ANT
    and HUMANOID players, as the JAX package's ``load_batch`` builds only
    BoxHead matches (``load`` builds them), and the batched path refuses
    ``MultiturnTask``, whose goals re-kick off on the host.  A tracking
    camera is taken by the task (and refuses a smoothing speed outside
    [0, 1])."""
    for kwargs in ({"walker_type": tsoccer.WalkerType.ANT},
                   {"walker_type": "humanoid"}):
        with pytest.raises(NotImplementedError, match="BoxHead"):
            tsoccer.load_batch(device="cpu", dtype=torch.float64, **kwargs)
        task = tsoccer.load(device="cpu", **kwargs).task
        assert len(task.players) == 4
    players = tsoccer.task.standard_players(1)
    cam = tsoccer.MultiplayerTrackingCamera(2.0, 1.0, 0.5)
    with pytest.raises(ValueError, match="speed"):
        tsoccer.MultiplayerTrackingCamera(2.0, 1.0, 1.5)
    task = tsoccer.Task(players, tsoccer.Pitch(), tracking_cameras=(cam,))
    assert task._tracking_cameras == (cam,)
    players = tsoccer.task.standard_players(1)
    with pytest.raises(TypeError, match="BatchableTask"):
        tbatch.compile_task(tsoccer.MultiturnTask(players, tsoccer.Pitch()),
                            device="cpu", dtype=torch.float64)
    env = _env("soccer_2v2")
    assert env.n_sub_steps == 5 and env.step_limit == 1800
    assert env.task.reward_shape == (4,)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tsoccer.load_batch(dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsoccer.load()


@pytest.mark.parametrize("kwargs,nv", [
    ({"team_size": 3}, 54), ({"pitch_size": (16, 12)}, 38),
    ({"disable_walker_contacts": True}, 38)])
def test_load_batch_builds_what_jax_builds(kwargs, nv):
    """The matches the JAX package's ``load_batch`` builds beyond the
    reference files: the port compiles the match's tree to the JAX
    compiler's model (``_Compiler``, bit for bit) and steps it, goals
    and field sized by the pitch."""
    import jax.numpy as jnp

    from dm_control_tpu.locomotion import soccer as jsoccer
    from dm_control_tpu.mjcf import compiler as jcompiler

    with pytest.MonkeyPatch.context() as mp:
        captured = {}
        from dm_control_tpu.composer import batch as jbatch

        mp.setattr(jbatch, "compile_task",
                   lambda task, **kw: captured.setdefault("task", task))
        jsoccer.load_batch(**kwargs)
    env = tsoccer.load_batch(device="cpu", dtype=torch.float64, **kwargs)
    task = env.task._t
    jroot = captured["task"].root_entity.mjcf_model
    opt = jroot.first("option")
    if opt is None:
        opt = jroot.add("option")
    opt.attrib["timestep"] = str(captured["task"].physics_timestep)
    model_io_tests._assert_same(
        tcompiler._Compiler(task.root_entity.mjcf_model).compile(),
        model_io.from_jax_model(jcompiler._Compiler(
            jroot, jnp.float64).compile()))
    assert env.model.nv == nv
    state, _ = env.reset(2, torch.Generator().manual_seed(0))
    for _ in range(2):
        state, ts = env.step(state, torch.zeros(2, env.model.nu,
                                                dtype=torch.float64))
    assert ts.reward.shape == (2, 2 * kwargs.get("team_size", 2))
    assert bool(torch.isfinite(state.data.qpos).all())
    if "pitch_size" in kwargs:
        np.testing.assert_array_equal(task.arena.away_goal.upper,
                                      captured["task"].arena.away_goal.upper)
    if kwargs.get("disable_walker_contacts"):
        m = env.model
        walker_geoms = [g for n, g in m.names.geom.items()
                        if n.startswith(("home", "away"))]
        assert walker_geoms
        assert not any(m.geom_contype[g] for g in walker_geoms)


@pytest.mark.parametrize("asset,nv,candidates", [("soccer_1v1", 22, 136),
                                                 ("soccer_2v2", 38, 391)])
def test_model_sizes(asset, nv, candidates):
    """No contact compaction: under 512 candidates float32 keeps them
    all, as in the JAX package."""
    from dm_control_torch.physics import collision

    env = tsoccer.load_batch(team_size=ASSETS[asset], device="cpu",
                             dtype=torch.float32)
    assert env.model.nv == nv and env.model.opt.contact_cap == 0
    assert len(collision.contact_rows_static(env.model)[0]) == candidates
    assert bool((env.model.dof_damping > 0).any())  # implicit Euler


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
