"""The port's locomotion example environments against the JAX package's,
in float64 on the CPU: ``locomotion.examples.basic.<name>`` -> the
entities' MJCF trees (the CMU 2019 humanoid, the rat, the corridors, the
mazes, the bowl, the target spheres) -> ``mjcf.compile_model`` ->
``composer.Environment``.

- ``composer.variation``: every distribution, the arithmetic and the
  noises drawn from one seed in both packages (values and the generator's
  state after); ``MJCFVariator`` against JAX's, ``PhysicsVariator`` on a
  compiled model.
- The arenas: ``covering.make_walls``, ``TextMaze`` (fixed, with tokens
  redrawn, carved), ``MazeWithTargets``' positions and the corridors'
  layouts (numpy's global state or a ``RandomState``) against JAX's.
- The nine environments' trees, and the 2019 humanoid with motors and the
  rat with its options, compile to the JAX compiler's model bit for bit
  (``_Compiler(root).compile()``, before ``set_const``) after the same
  draws.
- The tasks' hooks at shared states: the JAX task runs on a JAX
  ``Physics`` that holds the port's state (its forward is the port's),
  beside the port's task on the port's physics; the reset's draws
  exactly, then reward, termination, discount and every observation
  after the walker is moved: forward along a corridor and below it, onto
  the go-to-target target, onto each maze target in turn and lying on
  the floor, out of the bowl, and TwoTouch's touches in and out of their
  window with its timeouts.
- A host episode of four environments (``tools/export_torch_assets.py
  loco_example_goldens``) replayed one control step at a time from the
  recorded JAX state (``rl/golden.py``): the reset's draws exactly (qpos,
  the placed targets), every step within the golden gate.
- The default device is the card, and without CUDA an entry point
  raises before it draws anything.

JAX environments are built with ``composer.Environment`` replaced (no
MJCF compile, nothing jitted).  Marked ``slow``: each host golden equals
a fresh JAX episode.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import test_torch_model_io as model_io_tests
from _torch_helpers import export_tool, jax_model_from_port
from dm_control_torch import composer as tcomposer
from dm_control_torch.composer import variation as tvariation
from dm_control_torch.locomotion import arenas as tarenas
from dm_control_torch.locomotion import tasks as ttasks
from dm_control_torch.locomotion import walkers as twalkers
from dm_control_torch.locomotion.arenas import covering as tcovering
from dm_control_torch.locomotion.examples import basic as tbasic
from dm_control_torch.locomotion.examples import (
    basic_cmu_2019, basic_rodent_2020,
)
from dm_control_torch.locomotion.props import target_sphere as ttarget
from dm_control_torch.mjcf import compiler as tcompiler
from dm_control_torch.physics import model_io
from dm_control_torch.physics.physics import Physics as TPhysics
from dm_control_torch.rl import golden as tgolden

NAMES = ("cmu_humanoid_run_walls", "cmu_humanoid_run_gaps",
         "cmu_humanoid_go_to_target", "cmu_humanoid_maze_forage",
         "cmu_humanoid_heterogeneous_forage", "rodent_escape_bowl",
         "rodent_run_gaps", "rodent_maze_forage", "rodent_two_touch")
GOLDENS = export_tool().LOCO_EXAMPLE_GOLDENS
SEED = 3
OBS_ATOL = 1e-12
_LAYOUT = """*****
*P.G*
*.*.*
*G..*
*****"""


def _jax_lib():
    """The JAX package's modules under the port's names."""
    from dm_control_tpu.composer import variation
    from dm_control_tpu.locomotion import arenas, tasks, walkers
    from dm_control_tpu.locomotion.arenas import covering
    from dm_control_tpu.locomotion.props import target_sphere

    return types.SimpleNamespace(
        variation=variation, arenas=arenas, tasks=tasks, walkers=walkers,
        covering=covering, target_sphere=target_sphere)


PORT = types.SimpleNamespace(
    variation=tvariation, arenas=tarenas, tasks=ttasks, walkers=twalkers,
    covering=tcovering, target_sphere=ttarget)


def _no_environment(module, monkeypatch):
    """``module.composer.Environment`` replaced: the entry point returns
    its task and keyword arguments (no MJCF compile)."""
    monkeypatch.setattr(module.composer, "Environment",
                        lambda task, **kw: types.SimpleNamespace(task=task,
                                                                 **kw))


def _jax_example(name, seed=SEED):
    """The JAX example's task, built after numpy's global state is seeded
    with ``seed`` (the corridors draw their layout from it)."""
    from dm_control_tpu.locomotion.examples import basic as jbasic

    with pytest.MonkeyPatch.context() as mp:
        _no_environment(jbasic, mp)
        np.random.seed(seed)
        return getattr(jbasic, name)().task


def _port_example(name, seed=SEED):
    np.random.seed(seed)
    return getattr(tbasic, name)(random_state=seed, device="cpu")


def _timestep(root, task):
    opt = root.first("option")
    if opt is None:
        opt = root.add("option")
    opt.attrib["timestep"] = str(task.physics_timestep)
    return root


# -- composer.variation --------------------------------------------------------

#: name -> (the variation, built from a package's ``variation``; the
#: current value it is evaluated at)
_DISTRIBUTIONS = {
    "uniform": (lambda v: v.distributions.Uniform(1, 7), None),
    "uniform_array": (lambda v: v.distributions.Uniform(-1, 1), np.zeros(3)),
    "uniform_single": (lambda v: v.distributions.Uniform(
        0, 2, single_sample=True), np.zeros(3)),
    "uniform_integer": (lambda v: v.distributions.UniformInteger(2, 9),
                        None),
    "uniform_choice": (lambda v: v.distributions.UniformChoice(
        [0.5, 1.5, 4.0]), np.zeros(2)),
    "point_on_sphere": (lambda v: v.distributions.UniformPointOnSphere(),
                        None),
    "normal": (lambda v: v.distributions.Normal(1.0, 0.3), np.zeros((2, 2))),
    "lognormal": (lambda v: v.distributions.LogNormal(0.0, 0.5), None),
    "exponential": (lambda v: v.distributions.Exponential(2.0), None),
    "poisson": (lambda v: v.distributions.Poisson(3.0), np.zeros(4)),
    "bernoulli": (lambda v: v.distributions.Bernoulli(0.3), np.zeros(5)),
    "lazy_arguments": (lambda v: v.distributions.Uniform(
        v.distributions.Uniform(0, 1), v.distributions.Normal(3, 0.1)),
        None),
    "arithmetic": (lambda v: -(2 * v.distributions.Uniform(0, 1)
                               + v.distributions.Normal() - 1
                               / v.distributions.Uniform(1, 2)) / 3, None),
    "additive": (lambda v: v.noises.Additive(v.distributions.Uniform(-1, 1)),
                 np.full(3, 5.0)),
    "additive_cumulative": (lambda v: v.noises.Additive(
        v.distributions.Normal(0, 0.1), cumulative=True), np.full(3, 5.0)),
    "multiplicative": (lambda v: v.noises.Multiplicative(
        v.distributions.Uniform(0.5, 1.5), cumulative=True), np.full(2, 4.0)),
}


@pytest.mark.parametrize("case", list(_DISTRIBUTIONS))
def test_variation_draws_match_jax(case):
    """Three evaluations from ``RandomState(5)`` in each package: the same
    values and the generator left in the same state."""
    build, current = _DISTRIBUTIONS[case]
    jv = _jax_lib().variation
    draws = []
    for lib in (tvariation, jv):
        rs = np.random.RandomState(5)
        var = build(lib)
        values = [lib.evaluate(var, initial_value=np.ones(3) * 2.0
                               if current is not None else 2.0,
                               current_value=current, random_state=rs)
                  for _ in range(3)]
        draws.append((values, rs.get_state()[1]))
    for ours, theirs in zip(draws[0][0], draws[1][0]):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(draws[0][1], draws[1][1])


def test_evaluate_and_variators_match_jax():
    """``evaluate`` through lists and tuples, numpy's global state where no
    generator is given, ``MJCFVariator`` on an element's attribute (twice,
    from its initial value) and ``PhysicsVariator`` on a compiled model."""
    from dm_control_tpu.mjcf.element import Element as JElement
    from dm_control_torch.mjcf.element import Element as TElement

    jv = _jax_lib().variation
    out = []
    for lib, element in ((tvariation, TElement), (jv, JElement)):
        u = lib.distributions.Uniform
        rs = np.random.RandomState(2)
        values = [lib.evaluate([u(0, 1), (u(2, 3), 4.0)], random_state=rs)]
        np.random.seed(9)
        values.append(lib.evaluate(u(0, 1)))
        geom = element("geom", {"name": "g", "size": np.array([.1, .2, .3])})
        variator = lib.MJCFVariator()
        for _ in range(2):
            variator.apply_variations(
                geom, {"size": lib.noises.Multiplicative(u(0.5, 1.5))}, rs)
            values.append(np.array(geom.get("size"), float))
        out.append(values)
    assert isinstance(out[0][0][1], tuple) and out[0][0][1][1] == 4.0
    np.testing.assert_equal(out[0], out[1])

    physics = TPhysics.from_xml_string(
        "<mujoco><worldbody><geom name='g' type='sphere' size='0.1'/>"
        "</worldbody></mujoco>", device="cpu")
    variator = tvariation.PhysicsVariator()
    rs = np.random.RandomState(4)
    for _ in range(2):
        variator.apply_variations(physics, [(
            "geom_size", (0, 0), tvariation.noises.Multiplicative(
                tvariation.distributions.Uniform(2.0, 3.0)))], rs)
    expect = np.random.RandomState(4).uniform(2.0, 3.0, 2)[1] * 0.1
    assert float(physics.model.geom_size[0, 0]) == expect
    assert physics.model.geom_size.dtype == torch.float64


# -- the arenas ----------------------------------------------------------------


@pytest.mark.parametrize("layout", ["examples", "small", "carved"])
def test_make_walls_matches_jax(layout):
    """The wall rectangles of a maze, in the JAX package's order, covering
    every wall cell once."""
    lib = _jax_lib()
    text = {"examples": tbasic._MAZE_LAYOUT, "small": _LAYOUT}.get(layout)
    if text is None:
        text = tarenas.TextMaze(height=11, width=13, random_seed=4)
    walls = tcovering.make_walls(text)
    jtext = text if isinstance(text, str) else lib.arenas.TextMaze(
        height=11, width=13, random_seed=4)
    assert [(tuple(w.start), tuple(w.end)) for w in walls] == [
        (tuple(w.start), tuple(w.end))
        for w in lib.covering.make_walls(jtext)]
    cells = [(y, x) for w in walls for y in range(w.start.y, w.end.y)
             for x in range(w.start.x, w.end.x)]
    layer = getattr(text, "entity_layer", text)
    grid = np.array([list(r) for r in layer.splitlines() if r])
    assert sorted(cells) == sorted(map(tuple, np.argwhere(grid == "*")))


@pytest.mark.parametrize("case", ["fixed", "fixed_tokens_redrawn",
                                  "carved"])
def test_text_maze_matches_jax(case):
    """A fixed layout, one whose spawns and objects are redrawn, and a
    carved one, each regenerated twice from a ``RandomState``: the same
    layers, tokens and generator state as JAX's."""
    kwargs = {"fixed": dict(entity_layer=_LAYOUT),
              "fixed_tokens_redrawn": dict(entity_layer=tbasic._MAZE_LAYOUT,
                                           num_spawns=2, num_objects=3,
                                           random_seed=1),
              "carved": dict(height=10, width=12, num_objects=2,
                             random_seed=6)}[case]
    mazes = [lib.arenas.TextMaze(**kwargs) for lib in (PORT, _jax_lib())]
    rss = [np.random.RandomState(8), np.random.RandomState(8)]
    for k in range(3):
        if k:
            for maze, rs in zip(mazes, rss):
                maze.regenerate(rs)
        assert mazes[0].entity_layer == mazes[1].entity_layer
        for token in "PG":
            assert mazes[0].find_tokens(token) == mazes[1].find_tokens(token)
    np.testing.assert_array_equal(rss[0].get_state()[1],
                                  rss[1].get_state()[1])
    if case == "carved":
        assert (mazes[0].height, mazes[0].width) == (11, 13)


def test_maze_arena_positions_match_jax():
    """``MazeWithTargets``' spawn and target positions, the grid/world maps
    and the wall geoms' attributes, before and after a regeneration."""
    arenas = [lib.arenas.MazeWithTargets(
        lib.arenas.TextMaze(height=9, width=9, num_objects=3,
                            random_seed=2), xy_scale=0.5, z_height=0.3)
              for lib in (PORT, _jax_lib())]
    for k in range(2):
        if k:
            for arena in arenas:
                arena.regenerate(np.random.RandomState(1))
        ours, theirs = arenas
        for what in ("spawn_positions", "target_positions"):
            np.testing.assert_array_equal(getattr(ours, what),
                                          getattr(theirs, what))
        np.testing.assert_array_equal(
            ours.world_to_grid_positions(ours.target_positions),
            theirs.world_to_grid_positions(theirs.target_positions))
        assert ours.mjcf_model.to_xml_string() == \
            theirs.mjcf_model.to_xml_string()
        assert len(ours.target_positions) == 3


@pytest.mark.parametrize("case", ["gaps_global", "gaps_random_state",
                                  "walls_global", "walls_random_state",
                                  "empty"])
def test_corridor_layouts_match_jax(case):
    """The corridors' geoms drawn from numpy's global state (as the
    examples build them) or from a given ``RandomState``: the same trees
    and generator states as JAX's; the layout is drawn once, when the
    arena is built."""
    trees, states = [], []
    for lib in (PORT, _jax_lib()):
        d = lib.variation.distributions
        np.random.seed(4)
        rs = (np.random.RandomState(7) if case.endswith("random_state")
              else None)
        if case.startswith("gaps"):
            arena = lib.arenas.GapsCorridor(
                platform_length=d.Uniform(0.4, 0.8),
                gap_length=d.Uniform(0.05, 0.2), corridor_width=2,
                corridor_length=12, random_state=rs)
        elif case.startswith("walls"):
            arena = lib.arenas.WallsCorridor(
                wall_gap=d.Uniform(2, 3), wall_width=d.Uniform(1, 3),
                swap_wall_side=rs is None, random_state=rs)
        else:
            arena = lib.arenas.EmptyCorridor(corridor_width=3,
                                             visible_side_planes=True)
        trees.append(arena.mjcf_model.to_xml_string())
        states.append([np.random.get_state()[1]] + (
            [] if rs is None else [rs.get_state()[1]]))
    assert trees[0] == trees[1]
    for ours, theirs in zip(*states):
        np.testing.assert_array_equal(ours, theirs)
    if case != "empty":
        assert trees[0].count('type="box"') > 3


# -- trees ---------------------------------------------------------------------


def _other_tree(lib, which):
    """A task of walkers and options the examples do not build."""
    w = lib.walkers
    if which == "cmu_2019_torque":
        return lib.tasks.GoToTarget(walker=w.CMUHumanoid(),
                                    arena=lib.arenas.Floor())
    if which == "rat_torque_foot_mods":
        return lib.tasks.TwoTouch(
            walker=w.Rat(torque_actuators=True, foot_mods=True),
            arena=lib.arenas.Floor(size=(2, 2)))
    return lib.tasks.RepeatSingleGoalMazeAugmentedWithTargets(
        walker=w.RollingBallWithHead(),
        main_target=lib.target_sphere.TargetSphere(name="main"),
        maze_arena=lib.arenas.MazeWithTargets(
            lib.arenas.TextMaze(_LAYOUT)), num_subtargets=3)


_OTHER_TREES = ("cmu_2019_torque", "rat_torque_foot_mods",
                "ball_maze_with_subtargets")


@pytest.mark.parametrize("tree", NAMES + _OTHER_TREES)
def test_tree_compiles_like_jax(tree, monkeypatch):
    """The port's compiler on the port's tree equals the JAX compiler on
    the JAX task's tree, every leaf bit for bit, after the same draws."""
    import jax.numpy as jnp

    from dm_control_tpu.mjcf import compiler as jcompiler

    if tree in NAMES:
        _no_environment(tbasic, monkeypatch)
        np.random.seed(SEED)
        task = getattr(tbasic, tree)(device="cpu").task
        jtask = _jax_example(tree)
    else:
        task, jtask = _other_tree(PORT, tree), _other_tree(_jax_lib(), tree)
    model = tcompiler._Compiler(
        _timestep(task.root_entity.mjcf_model, task)).compile()
    model_io_tests._assert_same(model, model_io.from_jax_model(
        jcompiler._Compiler(_timestep(jtask.root_entity.mjcf_model, jtask),
                            jnp.float64).compile()))
    nv = 73 if "rodent" in tree or "rat" in tree else (
        8 if "ball" in tree else 62)
    assert model.nv == nv


# -- the tasks' hooks at shared states -------------------------------------------

#: the Data fields a forward starts from
_STATE = ("time", "qpos", "qvel", "act", "ctrl", "qfrc_applied",
          "xfrc_applied", "qacc_warmstart")


def _to_jax(template, mine):
    """A JAX Data (or Contact) with every tensor of the port's ``mine`` (one
    environment, no batch axis) in place of ``template``'s."""
    import jax.numpy as jnp

    fields = {}
    for f in dataclasses.fields(template):
        value = getattr(mine, f.name, None)
        if isinstance(value, torch.Tensor):
            fields[f.name] = jnp.asarray(value.detach().cpu().numpy())
        elif dataclasses.is_dataclass(value):
            fields[f.name] = _to_jax(getattr(template, f.name), value)
    return template.replace(**fields)


def _bridge(env):
    """A JAX ``Physics`` of the port environment's model whose forward is
    the port's (JAX's state and body positions in, the port's Data out):
    the JAX task reads what the port computes, and nothing is jitted."""
    from dm_control_tpu.physics.model import make_data
    from dm_control_tpu.physics.physics import Physics as JPhysics

    jm = jax_model_from_port(env.physics.model)
    template = make_data(jm)

    class Bridge(JPhysics):
        def forward(self):
            model = env.physics.model
            body_pos = torch.tensor(np.asarray(self._model.body_pos))
            if not torch.equal(body_pos, model.body_pos):
                model = model.replace(body_pos=body_pos)
            physics = TPhysics(model)
            physics.set_data(**{f: np.asarray(getattr(self._data, f))
                                for f in _STATE})
            physics.forward()
            self._data = _to_jax(template, physics.data)
            self._dirty = False

        def sync(self):
            """The port environment's present state."""
            self._data = _to_jax(template, env.physics.data)
            self._dirty = False

    return Bridge(jm, template)


class _Lockstep:
    """A port environment and the same JAX task on a ``_bridge`` physics,
    their hooks run side by side from generators of one seed."""

    def __init__(self, env, jtask, seed=SEED):
        self.env, self.task, self.jtask = env, env.task, jtask
        self.jrs = np.random.RandomState(seed)
        self.jphysics = _bridge(env)

    @property
    def physics(self):
        return self.env.physics

    def _compare(self):
        ours, theirs = self.physics, self.jphysics
        np.testing.assert_array_equal(ours.model.body_pos.numpy(),
                                      np.asarray(theirs.model.body_pos))
        np.testing.assert_array_equal(self.env.random_state.get_state()[1],
                                      self.jrs.get_state()[1])
        obs = {k: o(ours) for k, o in self.task.observables.items()
               if o.enabled}
        jobs = {k: o(theirs) for k, o in self.jtask.observables.items()
                if o.enabled}
        assert list(obs) == list(jobs)
        for k in obs:
            np.testing.assert_allclose(np.asarray(obs[k], float),
                                       np.asarray(jobs[k], float), rtol=0,
                                       atol=OBS_ATOL, err_msg=k)

    def reset(self):
        """The port environment's reset beside the JAX task's hooks of a
        reset (``composer.Environment``'s order): the same draws, qpos and
        placed bodies exactly, then the observations."""
        self.env.reset()
        jt, jp, jrs = self.jtask, self.jphysics, self.jrs
        jt.initialize_episode_mjcf(jrs)
        for entity in jt.root_entity.iter_entities():
            entity.initialize_episode_mjcf(jrs)
        jt.after_compile(jp, jrs)
        with jp.reset_context():
            jt.initialize_episode(jp, jrs)
            for entity in jt.root_entity.iter_entities():
                entity.initialize_episode(jp, jrs)
        np.testing.assert_array_equal(self.physics.data.qpos.numpy(),
                                      np.asarray(jp.data.qpos))
        self._compare()

    def after_step(self):
        """Both tasks' after-step hooks at the port's present state (brought
        up to date by a forward where it is not): (reward, terminate,
        discount), equal in both."""
        self.physics._ensure_clean()
        self.jphysics.sync()
        out = []
        for task, physics, rs in ((self.task, self.physics,
                                   self.env.random_state),
                                  (self.jtask, self.jphysics, self.jrs)):
            task.after_step(physics, rs)
            for entity in task.root_entity.iter_entities():
                entity.after_step(physics, rs)
            terminate = bool(task.should_terminate_episode(physics))
            out.append((float(task.get_reward(physics)), terminate,
                        float(task.get_discount(physics))))
        assert out[0] == out[1]
        self._compare()
        return out[0]

    def move(self, walker, position=None, quaternion=None, time=None):
        """Sets the walker's pose (and the physics' time) on the port."""
        walker.set_pose(self.physics, position=position,
                        quaternion=quaternion)
        if time is not None:
            self.physics.set_data(time=time)
        self.physics.forward()

    def root(self, walker):
        return np.asarray(walker.root_xpos(self.physics), float)


def _lockstep(name):
    return _Lockstep(_port_example(name), _jax_example(name))


def _lying(walker):
    """The walker on its side, resting low."""
    z = 0.1 if isinstance(walker, twalkers.CMUHumanoid) else 0.02
    return z, (np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0)


@pytest.mark.parametrize("name", ["cmu_humanoid_run_walls",
                                  "cmu_humanoid_run_gaps",
                                  "rodent_run_gaps"])
def test_corridor_hooks_match_jax(name):
    """The corridor's reward for a step forward and one back (clipped), and
    the failure below ``terminate_at_height``: discount 0."""
    run = _lockstep(name)
    run.reset()
    walker = run.task._walker
    start = run.root(walker)
    rewards = []
    for dx in (0.03, 0.5, -0.2):
        run.move(walker, position=run.root(walker) + [dx, 0, 0])
        rewards.append(run.after_step())
    assert rewards[0][0] > 0 and rewards[1][0] == 1.0
    assert rewards[2][0] < 0 and not rewards[2][1]
    run.move(walker, position=start - [0, 0, start[2] + 0.6])
    assert run.after_step()[1:] == (True, 0.0)


def test_go_to_target_hooks_match_jax():
    """The drawn target, the reward away from it and on it, and the
    ``target`` observable (checked with every other at each state)."""
    run = _lockstep("cmu_humanoid_go_to_target")
    run.reset()
    walker = run.task._walker
    assert run.after_step()[0] == 0.0
    target = run.task._target_pos
    run.move(walker, position=[target[0], target[1], 1.3])
    assert run.after_step() == (1.0, False, 1.0)
    assert run.task._reward_step_counter == 1


@pytest.mark.parametrize("name", ["cmu_humanoid_maze_forage",
                                  "cmu_humanoid_heterogeneous_forage",
                                  "rodent_maze_forage"])
def test_maze_hooks_match_jax(name):
    """The spawn and target draws; a non-foot contact with the floor ends
    the episode with discount 0; each target pays once when the walker
    reaches it (the heterogeneous maze by type), and the last one ends
    the episode (as does the walker's contact with the floor there)."""
    run = _lockstep(name)
    run.reset()
    task = run.task
    walker = task._walker
    spawn = run.root(walker)
    z, quat = _lying(walker)
    run.move(walker, position=[spawn[0], spawn[1], z], quaternion=quat)
    assert run.after_step()[1:] == (True, 0.0)
    rewards = []
    for target in task._targets:
        xpos = run.physics.named_field("xpos",
                                       target.attachment_frame.get("name"))
        run.move(walker, position=xpos, quaternion=(1, 0, 0, 0))
        rewards.append(run.after_step())
    expected = [task._target_type_rewards[t] for t in task._target_types]
    assert [r for r, _, _ in rewards] == expected
    assert rewards[-1][1]


def test_escape_hooks_match_jax():
    """The bowl's reward at the centre, outside the terrain and tilted."""
    run = _lockstep("rodent_escape_bowl")
    run.reset()
    walker = run.task._walker
    centre = run.after_step()[0]
    run.move(walker, position=[25.0, 0.0, 0.2])
    far = run.after_step()[0]
    tilt = np.deg2rad(50)
    run.move(walker, quaternion=(np.cos(tilt / 2), np.sin(tilt / 2), 0, 0))
    tilted = run.after_step()[0]
    assert centre < 1e-3 and far == 1.0 and 0 < tilted < far


def test_two_touch_state_machine_matches_jax():
    """TwoTouch's states and rewards in both packages: a touch, a second
    in its window (reward twice), the timeout redrawing the target; a
    second touch too soon; no second touch."""
    from dm_control_torch.locomotion.tasks import TwoTouchState as S

    run = _lockstep("rodent_two_touch")
    run.reset()
    task = run.task
    walker = task._walker

    def touch(t, on=True):
        tpos = run.physics.named_field(
            "xpos", task._target.attachment_frame.get("name"))
        offset = (tpos - task._effector_pos(run.physics)) if on else [
            0.5, 0.5, 0.0]
        run.move(walker, position=run.root(walker) + offset, time=t)
        reward = run.after_step()[0]
        return reward, task._state

    assert task._state == S.PRE_TOUCH
    assert touch(0.1) == (1.0, S.TOUCHED_ONCE)
    assert touch(0.2, on=False) == (0.0, S.TOUCHED_ONCE)
    assert touch(0.9) == (2.0, S.TOUCHED_TWICE)
    body_pos = run.physics.model.body_pos.numpy().copy()
    assert touch(2.2, on=False) == (0.0, S.PRE_TOUCH)  # the timeout
    assert not np.array_equal(body_pos, run.physics.model.body_pos.numpy())
    assert touch(2.3) == (1.0, S.TOUCHED_ONCE)
    assert touch(2.35, on=False)[1] == S.TOUCHED_ONCE
    assert touch(2.4) == (0.0, S.TOUCHED_TOO_SOON)
    assert touch(3.7, on=False)[1] == S.PRE_TOUCH
    assert touch(3.8) == (1.0, S.TOUCHED_ONCE)
    assert touch(4.8, on=False) == (0.0, S.NO_SECOND_TOUCH)


@pytest.mark.parametrize("cls", ["NullGoalMaze", "RepeatSingleGoalMaze",
                                 "RepeatSingleGoalMazeAugmentedWithTargets"])
def test_other_maze_tasks_match_jax(cls):
    """The maze tasks the examples do not build, with the rolling ball: the
    global observables, a target repeated once (redrawn on activation)
    and the subtargets' rewards."""
    tasks = []
    for lib in (PORT, _jax_lib()):
        arena = lib.arenas.MazeWithTargets(lib.arenas.TextMaze(_LAYOUT))
        walker = lib.walkers.RollingBallWithHead()
        kwargs = dict(walker=walker, maze_arena=arena,
                      contact_termination=False)
        if cls == "NullGoalMaze":
            task = lib.tasks.NullGoalMaze(
                enable_global_task_observables=True, aliveness_reward=0.5,
                **kwargs)
        elif cls == "RepeatSingleGoalMaze":
            task = lib.tasks.RepeatSingleGoalMaze(max_repeats=1, **kwargs)
        else:
            task = lib.tasks.RepeatSingleGoalMazeAugmentedWithTargets(
                main_target=lib.target_sphere.TargetSphere(name="main"),
                num_subtargets=3, **kwargs)
        tasks.append(task)
    env = tcomposer.Environment(tasks[0], time_limit=1.0, random_state=SEED,
                                device="cpu")
    run = _Lockstep(env, tasks[1])
    run.reset()
    task = run.task
    walker = task._walker
    assert run.after_step()[0] == (0.5 if cls == "NullGoalMaze" else 0.0)
    if cls == "NullGoalMaze":
        assert "maze_layout" in task.observables
        return
    rewards = []
    for _ in range(2):
        xpos = run.physics.named_field(
            "xpos", task._target.attachment_frame.get("name"))
        run.move(walker, position=xpos)
        rewards.append(run.after_step())
    if cls == "RepeatSingleGoalMaze":
        assert rewards == [(1.0, False, 1.0), (1.0, True, 1.0)]
    else:
        assert rewards[0][0] >= 10.0


# -- host episodes against the JAX package's -----------------------------------


def _golden(name):
    with np.load(export_tool().loco_env_golden_path(name),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", GOLDENS)
def test_host_episode_matches_golden(name):
    """The recorded JAX episode replayed one control step at a time: the
    reset's draws exactly (qpos, the placed targets' body positions),
    every timestep within the golden gate (``-s`` prints the figures)."""
    gold = _golden(name)
    seed = export_tool().LOCO_ENV_SEED
    env = _port_example(name, seed)
    errs = tgolden.host_episode_errors(env, gold)
    figures, ok = tgolden.episode_gate(errs, gold, name)
    print(f"\n{name}: " + ", ".join(f"t{t} rest {a:.3e} qacc_warmstart "
                                    f"{b:.3e}" for t, (a, b) in
                                    enumerate(figures)))
    assert ok, figures
    assert errs[0]["step_qpos"] == 0.0
    assert errs[0]["model_body_pos"] == errs[0]["model_geom_size"] == 0.0
    assert len(errs) == export_tool().LOCO_ENV_STEPS + 1


@pytest.mark.slow
@pytest.mark.parametrize("name", GOLDENS)
def test_host_golden_equals_what_jax_gives_now(name):
    gold = _golden(name)
    fresh = export_tool().make_loco_env_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


# -- the entry points ------------------------------------------------------------


def test_entry_points():
    """The nine names, re-exported by ``basic_cmu_2019`` and
    ``basic_rodent_2020`` as in JAX; each defaults to the card and,
    without CUDA, raises before it draws from numpy's global state."""
    from dm_control_tpu.locomotion.examples import basic as jbasic

    for module, prefix in ((basic_cmu_2019, "cmu_humanoid_"),
                           (basic_rodent_2020, "rodent_")):
        names = sorted(n for n in dir(module) if n.startswith(prefix))
        assert names == sorted(n for n in NAMES if n.startswith(prefix))
        assert all(getattr(module, n) is getattr(tbasic, n) for n in names)
    assert sorted(n for n in dir(jbasic) if n.startswith(
        ("cmu_humanoid_", "rodent_"))) == sorted(NAMES)
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works")
    for name in NAMES:
        np.random.seed(0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(tbasic, name)()
        assert np.random.get_state()[2] == np.random.RandomState(
            0).get_state()[2]
        np.testing.assert_array_equal(np.random.get_state()[1],
                                      np.random.RandomState(0).get_state()[1])
