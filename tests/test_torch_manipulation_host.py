"""The port's manipulation tasks on composer's host path against the JAX
package's, in float64 on the CPU: ``manipulation.load`` -> the entities'
MJCF trees -> ``mjcf.compile_model`` -> ``composer.Environment``.

- The registry (``ALL``, ``TAGS``, the names of each tag) equals the JAX
  package's, and every name loads as a ``composer.Environment``.
- Each of the 11 distinct entity trees (a ``_vision`` name shares its
  ``_features`` name's tree; random order and reassembly change no tree)
  compiles to the JAX compiler's model bit for bit
  (``_Compiler(root).compile()``, before ``set_const``), and every name
  builds its tree.  The four batchable trees, compiled by ``load_batch``
  with nothing loaded from ``manipulation/assets/``, equal their reference
  files (the JAX compiler's output): the compiler's fields exactly, the
  ``set_const`` fields within 1e-10 of each field's largest entry.  The
  Jaco literals equal the JAX package's; its joint ranges survive the
  attach under the degree-default arena.
- A host episode of each of four tasks (``tools/export_torch_assets.py
  manip_env_goldens``: reach_site, lift_large_box, place_cradle and the
  three bricks stacked in random order) replayed one control step at a
  time from the recorded JAX state (``rl/golden.py``): the reset's draws
  exactly (qpos, and the stud radii in the compiled model), every step
  within the golden gate.  Each recorded state was checked by a nudge of
  one rounding of qpos and qvel on the port alone: the next step moves by
  less than the gate.
- The host hooks against the port's batched hooks of the same task at a
  shared state (reach, lift), as ``tests/test_batch_host_parity.py`` holds
  the JAX package's.
- ``manipulation.load(name, seed=42, device="cpu")`` resets and takes two
  control steps with finite rewards and observations for the five names
  of ``tests/test_manipulation.py`` and the five-brick reassembly; the
  features and vision variants observe the JAX tasks' keys.

JAX tasks are built without their ``composer.Environment`` (which would
compile the MJCF).  Marked ``slow``: each host golden equals a fresh JAX
episode.
"""

import types

import numpy as np
import pytest
import torch

from _torch_helpers import export_tool
from dm_control_torch import composer as tcomposer
from dm_control_torch import manipulation as tmanip
from dm_control_torch.composer import batch as tbatch
from dm_control_torch.entities.props.duplo import BRICK_HEIGHT, Duplo
from dm_control_torch.manipulation.shared import registry as tregistry
from dm_control_torch.mjcf import compiler as tcompiler
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import model_io
from dm_control_torch.physics.physics import Physics
from dm_control_torch.rl import golden as tgolden
from test_torch_model_io import _assert_same

#: tree -> the first registry name that builds it
TREES = {
    "reach_site": "reach_site_features",
    "reach_duplo": "reach_duplo_features",
    "lift_brick": "lift_brick_features",
    "lift_large_box": "lift_large_box_features",
    "place_brick": "place_brick_features",
    "place_cradle": "place_cradle_features",
    "stack_2_fixed": "stack_2_bricks_features",
    "stack_3_fixed": "stack_3_bricks_features",
    "stack_2_free": "stack_2_bricks_moveable_base_features",
    "stack_3_free": "stack_2_of_3_bricks_random_order_features",
    "stack_5_free": "reassemble_5_bricks_random_order_features",
}
#: the bricks names beyond the first of their tree
_STACKS = {
    "stack_3_bricks_random_order_features": "stack_3_fixed",
    "reassemble_3_bricks_fixed_order_features": "stack_3_free",
}
#: reference file -> its batchable task
ASSETS = export_tool().MANIPULATION_ASSETS
#: the names ``tests/test_manipulation.py`` runs, and the 5-brick reassembly
RUN_NAMES = ("reach_site_features", "reach_duplo_features",
             "lift_brick_features", "place_brick_features",
             "stack_2_bricks_features",
             "reassemble_5_bricks_random_order_features")
GOLDENS = export_tool().MANIP_ENV_GOLDENS
SET_CONST_REL = 1e-10


def _tree_of(name):
    base = name[:-len("_features")] if name.endswith("_features") else \
        name[:-len("_vision")]
    features = base + "_features"
    if features in _STACKS:
        return _STACKS[features]
    return next(t for t, n in TREES.items() if n == features)


def _jax_env(name):
    """The JAX package's factory of a registry name with
    ``composer.Environment`` replaced (no MJCF compile): the task and the
    environment's keyword arguments."""
    from dm_control_tpu import composer as jcomposer
    from dm_control_tpu import manipulation  # noqa: F401
    from dm_control_tpu.manipulation.shared import registry

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcomposer, "Environment",
                   lambda task, **kwargs: types.SimpleNamespace(task=task,
                                                                **kwargs))
        return registry.get(name)()


def _jax_task(name):
    return _jax_env(name).task


def _compile(task):
    return tcompiler._Compiler(task.root_entity.mjcf_model).compile()


def _golden(name):
    with np.load(export_tool().manip_env_golden_path(name),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# -- registry and trees ---------------------------------------------------------


@pytest.mark.parametrize("tag", ["features", "vision", "easy"])
def test_registry_matches_jax(tag):
    from dm_control_tpu import manipulation as jmanip

    assert tmanip.ALL == jmanip.ALL and len(tmanip.ALL) == 25
    assert tmanip.TAGS == jmanip.TAGS
    assert tmanip.get_environments_by_tag(tag) == \
        jmanip.get_environments_by_tag(tag)


@pytest.mark.parametrize("tree", TREES)
def test_tree_compiles_like_jax(tree):
    """The port's compiler on the port's tree equals the JAX compiler on
    the JAX task's tree, every leaf bit for bit."""
    import jax.numpy as jnp

    from dm_control_tpu.mjcf import compiler as jcompiler

    name = TREES[tree]
    jm = jcompiler._Compiler(_jax_task(name).root_entity.mjcf_model,
                             jnp.float64).compile()
    _assert_same(_compile(tregistry.get(name)()),
                 model_io.from_jax_model(jm))


def test_every_name_builds_its_tree():
    """All 25 names build one of the 11 trees: a ``_vision`` name its
    ``_features`` name's, random order and reassembly their brick
    count's."""
    built = {tree: _compile(tregistry.get(name)())
             for tree, name in TREES.items()}
    for name in tmanip.ALL:
        _assert_same(_compile(tregistry.get(name)()), built[_tree_of(name)])
    nv = {tree: m.nv for tree, m in built.items()}
    assert nv == {"reach_site": 9, "reach_duplo": 15, "lift_brick": 15,
                  "lift_large_box": 15, "place_brick": 15,
                  "place_cradle": 15, "stack_2_fixed": 15,
                  "stack_3_fixed": 21, "stack_2_free": 21,
                  "stack_3_free": 27, "stack_5_free": 39}


@pytest.mark.parametrize("asset", ASSETS)
def test_load_batch_compiles_the_reference_model(asset, monkeypatch):
    """``load_batch`` compiles the task's tree, reading no file: its
    model against the reference file, compiler fields equal, ``set_const``
    fields within 1e-10 of each field's largest entry."""
    reference = model_io.load(export_tool().asset_path(asset), "cpu",
                              torch.float64)

    def no_file(*args, **kwargs):
        raise AssertionError("load_batch read a model file")

    monkeypatch.setattr(model_io, "load", no_file)
    env = tmanip.load_batch(ASSETS[asset], device="cpu", dtype=torch.float64)
    devs = model_io.deviations(env.model, reference)
    for k, rel in devs.items():
        assert rel <= (SET_CONST_REL if k in model_io.SET_CONST_FIELDS
                       else 0), (k, rel)


def test_primitive_arm_matches_jax():
    """``ArmTask(use_jaco=False)``: the primitive arm and hand build the
    JAX tree (compiled bit for bit) and step with finite observations."""
    import jax.numpy as jnp

    from dm_control_torch.manipulation.shared.task import ArmTask
    from dm_control_tpu.manipulation.shared.task import ArmTask as JArmTask
    from dm_control_tpu.mjcf import compiler as jcompiler

    def bare(base):
        class Bare(base):
            def get_reward(self, physics):
                return 0.0
        return Bare(use_jaco=False)

    task, jtask = bare(ArmTask), bare(JArmTask)
    _assert_same(_compile(task), model_io.from_jax_model(
        jcompiler._Compiler(jtask.root_entity.mjcf_model,
                            jnp.float64).compile()))
    env = tcomposer.Environment(task, device="cpu", random_state=0)
    ts = env.reset()
    ts = env.step(np.full(env.action_spec().shape, 0.1))
    assert list(ts.observation) == [k for k, o in jtask.observables.items()
                                    if o.enabled]
    assert ts.observation["arm/joints_torque"].shape == (9,)
    for v in ts.observation.values():
        assert np.all(np.isfinite(v))


def test_kinova_literals_equal_the_jax_packages():
    from dm_control_torch.entities.manipulators import kinova_models as t
    from dm_control_tpu.entities.manipulators import kinova_models as j

    assert t.ARM_MODEL == j.ARM_MODEL and t.HAND_MODEL == j.HAND_MODEL


def test_jaco_joint_ranges_survive_attach():
    """The radian-authored Jaco joint ranges under the degree-default
    arena (``tests/test_manipulation.py``'s pin): joint_2's range is
    [47, 313] degrees, not 57 times smaller."""
    m = tcompiler.compile_model(
        tregistry.get("reach_site_features")().root_entity.mjcf_model,
        device="cpu")
    rng = m.jnt_range.numpy()
    np.testing.assert_allclose(rng[m.names.joint["arm/joint_2"]],
                               [0.820305, 5.462881], rtol=1e-5)
    np.testing.assert_allclose(rng[m.names.joint["arm/joint_3"]],
                               [0.331613, 5.951573], rtol=1e-5)


# -- the environment ------------------------------------------------------------


@pytest.mark.parametrize("name", RUN_NAMES)
def test_task_runs(name):
    env = tmanip.load(name, seed=42, device="cpu")
    assert isinstance(env, tcomposer.Environment)
    assert env.physics.model.dtype == torch.float64
    ts = env.reset()
    assert ts.first()
    spec = env.action_spec()
    rng = np.random.RandomState(42)
    for _ in range(2):
        ts = env.step(rng.uniform(spec.minimum, spec.maximum, spec.shape))
        assert ts.mid() and np.isfinite(ts.reward) and ts.discount == 1.0
        for v in ts.observation.values():
            assert np.all(np.isfinite(np.asarray(v)))


@pytest.mark.parametrize("name", tmanip.ALL)
def test_every_name_loads_with_the_jax_keys(name):
    """Every name loads as a ``composer.Environment`` with the JAX
    factory's time limit; the enabled observables of its task (its
    entities' in tree order, then the task's) are the JAX task's: the
    features variants see the prop's pose, the vision variants do not."""
    def enabled(task):
        return [k for k, o in task.observables.items() if o.enabled]

    env = tmanip.load(name, device="cpu")
    jenv = _jax_env(name)
    assert isinstance(env, tcomposer.Environment)
    assert env._time_limit == jenv.time_limit
    assert env._n_sub_steps == 20
    keys = enabled(env.task)
    assert keys == enabled(jenv.task)
    assert keys[:3] == ["arm/joints_pos", "arm/joints_vel",
                        "arm/joints_torque"]
    assert (len(keys) > 3) == name.endswith("_features")


@pytest.mark.parametrize("name", ["lift_brick", "stack_2_bricks"])
def test_features_and_vision_reset_observations(name):
    obs = {v: tmanip.load(f"{name}_{v}", seed=0, device="cpu").reset()
           .observation for v in ("features", "vision")}
    prop = "brick" if name == "lift_brick" else "brick_1"
    assert f"{prop}/position" in obs["features"]
    assert f"{prop}/position" not in obs["vision"]
    assert list(obs["vision"]) == ["arm/joints_pos", "arm/joints_vel",
                                   "arm/joints_torque"]
    for k in obs["vision"]:
        np.testing.assert_array_equal(obs["vision"][k], obs["features"][k])


def test_reach_reward_is_one_at_the_target():
    env = tmanip.load("reach_site_features", seed=0, device="cpu")
    env.reset()
    task, physics = env.task, env.physics
    assert task.get_reward(physics) < 0.5
    task._target_pos = np.asarray(task._pinch_position(physics))
    assert task.get_reward(physics) == pytest.approx(1.0)


def test_load_defaults_to_the_card():
    env = tmanip.load("reach_site_vision", device="cpu", dtype=torch.float32)
    assert env.physics.model.dtype == torch.float32
    assert env.physics.model.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmanip.load("reach_site_vision")


# -- the stud radius, drawn each episode into the compiled model ---------------


def test_stud_radius_reaches_the_compiled_model():
    """``apply_stud_radius`` on a compiled, already stepped model gives the
    ``geom_size`` and ``geom_rbound`` that compiling the tree with that
    radius gives, in a model with a cache of its own, and the next forward
    reads them: two bricks, one on the other's studs, whose contact
    distances are those of the tree compiled with the radius (the masses
    stay the first compile's, as in the JAX package)."""
    from dm_control_torch.physics.model import make_data

    radius = 0.0049

    def stacked(top_radius=None):
        arena = tcomposer.Arena()
        bottom, top = Duplo(name="bottom"), Duplo(name="top")
        if top_radius is not None:
            top.set_stud_radius(top_radius)
            bottom.set_stud_radius(top_radius)
        arena.attach(bottom)
        frame = arena.add_free_entity(top)
        frame.attrib["pos"] = f"0 0 {BRICK_HEIGHT}"
        return Physics.from_mjcf_model(arena.mjcf_model, device="cpu"), \
            (bottom, top)

    def dist(m):
        return tengine.forward(m, make_data(m, 1)).contact.dist.numpy()

    physics, bricks = stacked()
    physics.step()
    before = physics.model
    for brick in bricks:
        brick.apply_stud_radius(physics, radius)
    assert physics.is_dirty and physics.model is not before
    assert before._cache and not physics.model._cache
    want, _ = stacked(radius)
    for f in ("geom_size", "geom_rbound"):
        np.testing.assert_array_equal(getattr(physics.model, f).numpy(),
                                      getattr(want.model, f).numpy())
    np.testing.assert_array_equal(physics.model.body_mass.numpy(),
                                  before.body_mass.numpy())
    np.testing.assert_array_equal(dist(physics.model), dist(want.model))
    assert not np.array_equal(dist(physics.model), dist(before))


# -- host vs batched ------------------------------------------------------------


@pytest.mark.parametrize("name", ["reach_site_features",
                                  "lift_brick_features"])
def test_host_and_batched_hooks_agree(name):
    """The task's host hooks (``get_reward``, its observables) and its
    batched hooks at the same state: a batched reset's environment 0, and
    after three batched steps (``tests/test_batch_host_parity.py``)."""
    from dm_control_torch.rl.control import apply_model_diff

    task = tregistry.get(name)()
    host = tcomposer.Environment(task, time_limit=10.0, device="cpu")
    host.reset()
    benv = tbatch.compile_task(task, device="cpu", dtype=torch.float64)
    state, _ = benv.reset(2, torch.Generator().manual_seed(3))
    m = benv.model
    if name.startswith("reach"):
        target = m.names.site["target"]
        task._target_pos = state.model_diff["site_pos"][0, target].numpy()
    else:
        task._target_height = float(state.model_diff["_target_height"][0])
    for step in range(2):
        if step:
            for _ in range(3):
                state, _ = benv.step(state, torch.zeros(2, m.nu,
                                                        dtype=m.dtype))
        mm = apply_model_diff(m, state.model_diff)
        d = tengine.forward(mm, benv._unstrip(state.data))
        obs = benv.task.observation(mm, d)
        reward = float(benv.task.reward(mm, d)[0])
        physics = host.physics
        physics.set_data(qpos=state.data.qpos[0], qvel=state.data.qvel[0])
        physics.forward()
        assert task.get_reward(physics) == pytest.approx(reward, abs=1e-12)
        assert not task.should_terminate_episode(physics)
        np.testing.assert_allclose(obs["pinch_position"][0].numpy(),
                                   task._pinch_position(physics), atol=1e-12)
        if name.startswith("reach"):
            np.testing.assert_allclose(obs["target_position"][0].numpy(),
                                       task._target_position(physics),
                                       atol=1e-12)
        else:
            np.testing.assert_allclose(obs["prop_position"][0].numpy(),
                                       task._prop.position(physics),
                                       atol=1e-12)
            assert float(obs["target_height"][0, 0]) == task._target_height
        host_obs = {k: o(physics) for k, o in task.observables.items()
                    if o.enabled}
        for k in ("arm/joints_pos", "arm/joints_vel"):
            np.testing.assert_array_equal(host_obs[k], obs[k][0].numpy())


# -- host episodes against the JAX package's -----------------------------------


@pytest.mark.parametrize("name", GOLDENS)
def test_host_episode_matches_golden(name):
    """The recorded JAX episode replayed one control step at a time: the
    reset's draws exactly (qpos, the stud radii), every timestep within
    the golden gate (``-s`` prints the figures)."""
    gold = _golden(name)
    env = tmanip.load(name, seed=export_tool().MANIP_ENV_SEED, device="cpu")
    errs = tgolden.host_episode_errors(env, gold)
    figures, ok = tgolden.episode_gate(errs, gold, name)
    print(f"\n{name}: " + ", ".join(f"t{t} rest {a:.3e} qacc_warmstart "
                                    f"{b:.3e}" for t, (a, b) in
                                    enumerate(figures)))
    assert ok, figures
    assert errs[0]["step_qpos"] == 0.0
    assert errs[0]["model_geom_size"] == errs[0]["model_geom_rbound"] == 0.0
    assert len(errs) == export_tool().MANIP_ENV_STEPS + 1
    if name.startswith("stack"):  # three bricks drew their stud radii
        m = env.physics.model
        studs = [m.names.geom[f"brick_{i}/stud_00"] for i in range(3)]
        radii = m.geom_size[studs, 0].tolist()
        assert len(set(radii)) == 1  # variation 0: the one radius
        assert radii[0] == pytest.approx(0.004647)


@pytest.mark.slow
@pytest.mark.parametrize("name", GOLDENS)
def test_host_golden_equals_what_jax_gives_now(name):
    gold = _golden(name)
    fresh = export_tool().make_manip_env_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)
