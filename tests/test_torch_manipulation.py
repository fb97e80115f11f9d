"""The port's batched manipulation path against the JAX package, in float64
on the CPU: ``manipulation.load_batch`` -> the tasks' batched hooks ->
``BatchEnv.reset/step`` on the Jaco models.

- From each manipulation golden (``tools/export_torch_assets.py
  manipulation``: reach_site, reach_duplo, lift_brick, lift_large_box)
  one ``BatchEnv.step`` passes ``rl/golden.py``'s gate.  The golden's later
  states reach the new code: the prop lies on the floor in every
  environment (prop-floor contacts active) and moves, and the brick's
  frame sensors read its velocity (its spin is rounding: it
  lands flat; ``tests/test_torch_sensors_frame.py`` holds turns and
  spins to JAX).  The goldens' states are ones where a step does not
  jump with rounding (``tools/export_torch_assets.py``: ``GOLDEN_KEYS``,
  ``FALL_STEPS``).
- The eight batchable tasks' observation, reward and termination equal the
  JAX tasks' batched hooks (``batch_observation``, ``batch_reward``,
  ``batch_termination``, vmapped) to 1e-10 on the same states: the JAX
  task reads the port's Data, through ``test_torch_tasks.py``'s functions.
  The states are the goldens' start and stepped states, state 0 moved to
  one the reward pays for.  The features and vision variants observe the
  same keys as in JAX.
- Each task's ``batch_init`` equals the JAX task's on draws from numpy
  RandomStates of the same seeds (``RandomContext`` of each package) to
  1e-12, and ends the RandomState in the same state.  The port's own
  draws (a torch generator, which cannot give ``jax.random``'s numbers)
  are held to their boxes: the arm within 0.2 rad of its home pose, the
  target and the prop in their workspaces, each spread over most of it.
- ``rewards.tolerance`` with a bound per environment (lift's target
  height) equals JAX's to 1e-12.
- The registry (``ALL``, ``TAGS``, ``get_environments_by_tag``) equals the
  JAX package's; the host-only tasks (bricks, place) raise ``TypeError``
  from ``load_batch`` and load through ``load``.

The port compiles each task's entity tree (``compile_task``); the
checked-in assets are the JAX compiler's output for the same trees
(``tests/test_torch_manipulation_host.py`` holds the compiles to them).
JAX tasks are built without their ``composer.Environment`` (which would
compile the MJCF), and JAX models come from the checked-in assets
(``_torch_helpers.jax_model_from_asset``).  Marked ``slow``: each golden
file equals a fresh JAX run, and each asset a fresh export.
"""

import types

import numpy as np
import pytest
import torch

import test_torch_model_io as model_io_tests
import test_torch_tasks as tasks
from _torch_helpers import PREFIXES, assert_step_matches_golden, \
    export_tool, golden, jax_model, jax_model_from_asset
from dm_control_torch import manipulation as tmanip
from dm_control_torch.composer import batch as tbatch
from dm_control_torch.manipulation.shared import registry as tregistry
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import model_io
from dm_control_torch.physics.model import SensorType
from dm_control_torch.rl.control import RandomContext, apply_model_diff
from dm_control_torch.rl.golden import start_state
from dm_control_torch.utils import rewards as trewards

#: asset -> its features task
ASSETS = export_tool().MANIPULATION_ASSETS
#: the eight batchable tasks -> their asset
TASKS = {f"{t[:-len('_features')]}_{v}": a for a, t in ASSETS.items()
         for v in ("features", "vision")}
ATOL = 1e-10


def _env(name, autoreset=False):
    return tmanip.load_batch(name, device="cpu", dtype=torch.float64,
                             autoreset=autoreset)


def _jax_task(name):
    """The JAX package's composer task of a registry name, built by its
    factory with ``composer.Environment`` replaced: no MJCF compile."""
    from dm_control_tpu import composer as jcomposer
    from dm_control_tpu import manipulation  # noqa: F401
    from dm_control_tpu.manipulation.shared import registry

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcomposer, "Environment",
                   lambda task, **kwargs: types.SimpleNamespace(task=task))
        return registry.get(name)().task


# -- rewards, registry, entry points ------------------------------------------


@pytest.mark.parametrize("case", ["lower", "upper"])
def test_tolerance_takes_a_bound_per_environment(case):
    """A (B,) tensor bound, as lift's target height: the port's checks of
    the bounds' order apply to numbers only, as in the JAX package."""
    import jax.numpy as jnp

    from dm_control_tpu.utils import rewards as jrewards

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, 64)
    bound = rng.uniform(-0.5, 0.5, 64)
    if case == "lower":  # lift's
        kwargs = dict(margin=0.3, value_at_margin=0.0, sigmoid="linear")
        bounds = (bound, np.inf)
    else:
        kwargs = dict(margin=0.2, sigmoid="gaussian")
        bounds = (-0.5, bound)
    got = trewards.tolerance(
        torch.as_tensor(x), bounds=tuple(
            torch.as_tensor(b) if isinstance(b, np.ndarray) else b
            for b in bounds), **kwargs)
    want = jrewards.tolerance(jnp.asarray(x), bounds=tuple(
        jnp.asarray(b) if isinstance(b, np.ndarray) else b
        for b in bounds), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert bool((got == 1).any()) and bool(((got > 0) & (got < 1)).any())
    with pytest.raises(ValueError):
        trewards.tolerance(torch.as_tensor(x), bounds=(1.0, 0.0))


def test_registry_matches_jax():
    from dm_control_tpu import manipulation as jmanip

    assert tmanip.ALL == jmanip.ALL and len(tmanip.ALL) == 25
    assert tmanip.TAGS == jmanip.TAGS
    for tag in jmanip.TAGS:
        assert tmanip.get_environments_by_tag(tag) == \
            jmanip.get_environments_by_tag(tag)
    batchable = [n for n in tmanip.ALL
                 if tbatch.implements_batch(tregistry.get(n)())]
    assert sorted(batchable) == sorted(TASKS)
    for name in TASKS:  # the variants' settings presets are the JAX ones
        assert tregistry.get(name)().obs_settings._asdict() == \
            _jax_task(name)._obs_settings._asdict()


def test_every_asset_file_belongs_to_a_task():
    """The files are references: each is the JAX compile of a batchable
    task's entity tree, and no task loads one (it has a root entity, and
    the batched protocol names no model file)."""
    import os

    on_disk = {f[:-len(".npz")] for f in os.listdir(os.path.dirname(
        export_tool().asset_path("reach_site")))}
    assert set(TASKS.values()) == on_disk == set(ASSETS)
    for name in TASKS:
        task = tregistry.get(name)()
        assert not hasattr(task, "model_asset")
        assert task.root_entity is not None


@pytest.mark.parametrize("name", ["place_brick_features",
                                  "stack_2_bricks_features",
                                  "reassemble_5_bricks_random_order_vision"])
def test_host_only_tasks_are_refused(name):
    from dm_control_torch import composer

    with pytest.raises(TypeError, match="BatchableTask"):
        tmanip.load_batch(name, device="cpu", dtype=torch.float64)
    assert isinstance(tmanip.load(name, device="cpu"), composer.Environment)


def test_entry_points():
    with pytest.raises(KeyError):
        tmanip.load("reach_nothing", device="cpu")
    with pytest.raises(KeyError):
        tmanip.load_batch("reach_nothing", device="cpu",
                          dtype=torch.float64)
    with pytest.raises(TypeError, match="BatchableTask"):
        tbatch.compile_task(object(), device="cpu", dtype=torch.float64)
    # the tree is compiled at the task's physics timestep
    task = tregistry.get("reach_site_features")()
    task.physics_timestep = 0.001
    env = tbatch.compile_task(task, device="cpu", dtype=torch.float64)
    assert float(env.model.opt.timestep) == 0.001 and env.n_sub_steps == 40
    env = _env("lift_brick_vision")
    assert env.n_sub_steps == 20 and env.step_limit == 250
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tmanip.load_batch("reach_site_features", dtype=torch.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmanip.load("reach_site_features")


@pytest.mark.parametrize("asset,candidates", [
    ("reach_site", 654), ("reach_duplo", 856), ("lift_brick", 856),
    ("lift_large_box", 776)])
def test_float32_compacts_the_candidate_contacts(asset, candidates):
    """Past 512 candidates ``BatchEnv`` caps float32 contacts at 64 a
    condim group, as the JAX package does; float64 keeps them all."""
    from dm_control_torch.physics import collision

    f64 = _env(ASSETS[asset])
    assert len(collision.contact_rows_static(f64.model)[0]) == candidates
    assert f64.model.opt.contact_cap == 0
    f32 = tmanip.load_batch(ASSETS[asset], device="cpu", dtype=torch.float32)
    assert f32.model.opt.contact_cap == 64


# -- the goldens ----------------------------------------------------------------


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("asset", ASSETS)
def test_batch_env_step_matches_golden(asset, prefix):
    assert_step_matches_golden(_env(ASSETS[asset]),
                               golden(f"manipulation_{asset}"), prefix)


@pytest.mark.parametrize("asset", ASSETS)
def test_golden_states_reach_the_new_code(asset):
    gold = golden(f"manipulation_{asset}")
    env = _env(ASSETS[asset])
    state = start_state(env, gold, "contact")
    m = apply_model_diff(env.model, state.model_diff)
    d = tengine.forward(m, env.task.before_step(
        m, env._unstrip(state.data), torch.as_tensor(
            gold["contact_actions"])))
    if asset == "reach_site":  # the target site of every episode differs
        target = m.names.site["target"]
        assert len(set(state.model_diff["site_pos"][:, target, 0]
                       .tolist())) == 4
        return
    # the prop on the floor in every environment, and moving
    task = env.task._t
    _, body = task._free_joint(m, task._prop)
    floor = m.names.geom["ground"]
    prop_floor = [c for c, (g1, g2) in enumerate(zip(d.contact.geom1,
                                                    d.contact.geom2))
                  if floor in (g1, g2)
                  and body in (m.geom_bodyid[g1], m.geom_bodyid[g2])]
    assert bool((d.contact.dist[:, prop_floor] < 0).any(-1).all())
    dof = m.jnt_dofadr[m.body_jntadr[body]]
    speed = d.qvel[:, dof:dof + 3].abs().amax(-1)
    assert float(speed.max()) > 1e-4
    frame = {SensorType(m.sensor_type[s]): slice(
        m.sensor_adr[s], m.sensor_adr[s] + m.sensor_dim[s])
        for s in range(m.nsensor)}
    if asset == "lift_large_box":  # a primitive: no sensors
        assert SensorType.FRAMELINVEL not in frame
        return
    # the brick's frame sensors: its velocity is the body's, its turn and
    # spin what rounding left (it lands flat)
    vel = d.sensordata[:, frame[SensorType.FRAMELINVEL]]
    np.testing.assert_allclose(vel.numpy(), d.qvel[:, dof:dof + 3].numpy(),
                               rtol=0, atol=1e-12)
    assert bool((vel.abs().amax(-1) > 1e-5).all())
    quat = d.sensordata[:, frame[SensorType.FRAMEQUAT]]
    assert bool((quat[:, 0] > 1 - 1e-12).all())
    spin = d.sensordata[:, frame[SensorType.FRAMEANGVEL]]
    assert bool((spin.abs().amax(-1) > 0).all())
    assert float(spin.abs().max()) < 1e-12


# -- the tasks' hooks against the JAX tasks' -----------------------------------


def _states(name):
    """(env, qpos, qvel, model_diff, ctrl) as float64 tensors: the golden's
    start and stepped states, with the start states' overrides, state 0
    moved to one the reward pays for."""
    gold = golden(f"manipulation_{TASKS[name]}")
    env = _env(name)
    m = env.model
    qpos, qvel, diffs = [], [], []
    for p in PREFIXES:
        for tag in (p, f"{p}_step"):
            qpos.append(gold[f"{tag}_qpos"])
            qvel.append(gold[f"{tag}_qvel"])
            diffs.append({k[len(f"{p}_diff_"):]: gold[k] for k in gold
                          if k.startswith(f"{p}_diff_")})
    qpos = torch.as_tensor(np.concatenate(qpos))
    qvel = torch.as_tensor(np.concatenate(qvel))
    diff = {k: torch.as_tensor(np.concatenate([d[k] for d in diffs]))
            for k in diffs[0]}
    n = qpos.shape[0]
    ctrl = torch.as_tensor(np.random.default_rng(n).uniform(-1, 1,
                                                            (n, m.nu)))
    _, d, _ = tasks._data(env, qpos, qvel, diff, ctrl)
    pinch = d.site_xpos[0, m.names.site["arm/hand/pinchsite"]]
    if "site_pos" in diff:  # the target under the pinch site
        diff["site_pos"][0, m.names.site["target"]] = pinch
    else:
        adr, _ = env.task._t._free_joint(m, env.task._t._prop)
        if "_target_height" in diff:  # the prop above its target height
            qpos[0, adr + 2] = diff["_target_height"][0] + 0.1
        else:  # the brick at the pinch site
            qpos[0, adr:adr + 3] = pinch
    return env, qpos, qvel, diff, ctrl


@pytest.mark.parametrize("name", TASKS)
def test_task_hooks_match_jax(name):
    from dm_control_tpu.composer.batch import _PureTaskAdapter

    env, qpos, qvel, diff, ctrl = _states(name)
    n = qpos.shape[0]
    (obs, reward, terminate, discount), d = tasks._port(env, qpos, qvel,
                                                        diff, ctrl)
    jenv = types.SimpleNamespace(
        model=jax_model_from_asset(TASKS[name]),
        task=_PureTaskAdapter(_jax_task(name)))
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
    np.testing.assert_allclose(discount.numpy(), np.asarray(jdiscount),
                               rtol=0, atol=0)
    assert float(reward[0]) > 0.5 and float(reward.min()) < 0.5


@pytest.mark.parametrize("asset", ASSETS)
def test_features_and_vision_observe_the_same_keys_as_jax(asset):
    """Both variants' observations from the port's reset against the JAX
    task's ``batch_observation`` of one environment (run eagerly)."""
    import jax

    from dm_control_tpu.rl.control import apply_model_diff as japply

    name = ASSETS[asset][:-len("_features")]
    jm = jax_model_from_asset(asset)
    keys = {}
    for variant in ("features", "vision"):
        env = _env(f"{name}_{variant}")
        state, ts = env.reset(1, torch.Generator().manual_seed(0))
        jtask = _jax_task(f"{name}_{variant}")
        jdiff = {k: np.asarray(v[0]) for k, v in state.model_diff.items()}
        jd = tasks.jax_data(jm, env._observe(state.replace(
            data=env._unstrip(state.data)))[0].data)
        jobs = jtask.batch_observation(japply(jm, jdiff),
                                       jax.tree.map(lambda x: x[0], jd))
        assert list(ts.observation) == list(jobs)
        keys[variant] = list(ts.observation)
    assert keys["features"] == keys["vision"]


# -- episode starts -------------------------------------------------------------


@pytest.mark.parametrize("asset", ASSETS)
def test_task_init_matches_jax(asset):
    """``batch_init`` of both packages on numpy draws of the same seeds:
    the same calls in the same order, the same starts to 1e-12."""
    import jax.numpy as jnp

    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_tpu.rl.control import RandomContext as JRandomContext

    env = _env(ASSETS[asset])
    m, task = env.model, env.task._t
    jm = jax_model_from_asset(asset)
    jtask = _jax_task(ASSETS[asset])
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
        assert diff.keys() == jdiff.keys()
        for k in diff:
            np.testing.assert_allclose(
                diff[k][0].numpy(), np.asarray(jnp.asarray(jdiff[k])),
                rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_array_equal(ours.get_state()[1],
                                      theirs.get_state()[1])
        assert ours.get_state()[2] == theirs.get_state()[2]


@pytest.mark.parametrize("asset", ASSETS)
def test_reset_draws_stay_in_their_boxes(asset):
    from dm_control_torch.manipulation import lift, reach

    env = _env(ASSETS[asset])
    m, task = env.model, env.task._t
    B = 256
    state, _ = env.reset(B, torch.Generator().manual_seed(4))
    arm = state.data.qpos[:, task._arm_qpos_addrs(m)] \
        - task._arm_joint_mids(m)
    assert bool((arm.abs() <= 0.2).all())
    assert bool((arm.amax(0) - arm.amin(0) > 0.35).all())

    def in_box(pos, box):
        lo, hi = (torch.as_tensor(b, dtype=pos.dtype) for b in box)
        assert bool(((pos >= lo) & (pos <= hi)).all())
        spread = pos.amax(0) - pos.amin(0)
        wide = hi > lo
        assert bool((spread[wide] > 0.8 * (hi - lo)[wide]).all())

    if asset == "reach_site":
        in_box(state.model_diff["site_pos"][:, m.names.site["target"]],
               reach._TARGET_BOX)
        return
    adr, _ = task._free_joint(m, task._prop)
    pos = state.data.qpos[:, adr:adr + 3]
    in_box(pos, reach._PROP_BOX if asset == "reach_duplo"
           else lift._PROP_BOX)
    if asset.startswith("lift"):
        np.testing.assert_allclose(
            state.model_diff["_target_height"].numpy(),
            (pos[:, 2] + task._prop.lowest_vertex_offset(m) + 0.3).numpy(),
            rtol=0, atol=1e-15)


@pytest.mark.parametrize("asset", ["lift_brick", "lift_large_box"])
def test_lowest_vertex_offset_matches_jax(asset):
    """The port reads it from the vertex sites' positions in the model; the
    JAX entity keeps the value it built them from.  The sites are on the
    prop's free body, spawned unrotated."""
    env = _env(ASSETS[asset])
    m, task = env.model, env.task._t
    jprop = _jax_task(ASSETS[asset])._prop
    assert task._prop.vertex_site_names() == jprop.vertex_site_names()
    np.testing.assert_allclose(task._prop.lowest_vertex_offset(m),
                               jprop.lowest_vertex_offset, rtol=0,
                               atol=1e-12)
    _, body = task._free_joint(m, task._prop)
    sites = task._prop.vertex_site_ids(m).tolist()
    assert {m.site_bodyid[s] for s in sites} == {body}
    np.testing.assert_array_equal(m.body_quat[body].numpy(),
                                  [1.0, 0.0, 0.0, 0.0])


# -- slow: the checked-in files against fresh JAX runs --------------------------


@pytest.mark.slow
@pytest.mark.parametrize("asset", ASSETS)
def test_golden_file_equals_what_jax_gives_now(asset):
    name = f"manipulation_{asset}"
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
