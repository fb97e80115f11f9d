"""Soccer's ANT and HUMANOID players, the walker helpers and the padded
room of the port against the JAX package's, in float64 on the CPU.

- The trees compile to the JAX compiler's model bit for bit
  (``_Compiler(root).compile()``, before ``set_const``): ``soccer.load``
  with ant players one and two a side, humanoid players one and two a
  side (nv 130 and 254: the global branch of ``chol_solve`` on the card
  in float64), BoxHead ten a side (nv 166, the block kernel's largest
  soccer match but one), the padded room as a maze arena with an ant, and
  a rescaled humanoid and an ant given scaled actuators on a floor.
- A host episode of an ant match two a side on a fixed (12, 9) pitch and
  a humanoid match one a side on the pitch drawn from the humanoids'
  areas (``tools/export_torch_assets.py loco_walker_goldens``) replayed
  one control step at a time from the recorded JAX state
  (``rl/golden.py``): the reset's draws exactly (qpos, the drawn pitch),
  every step within the golden gate.
- The soccer hooks at shared states: the JAX task runs on a JAX
  ``Physics`` whose forward is the port's beside the port's task (the
  initializer's draws and free-root poses, every observable, the rewards
  with the ball in each goal), and the walkers' own properties.

Nothing here steps a humanoid match two a side: it is compiled only.
Marked ``slow``: each host golden equals a fresh JAX episode.
"""

import types

import numpy as np
import pytest

import test_torch_locomotion_examples as lex
import test_torch_locomotion_host as lhost
import test_torch_model_io as model_io_tests
from _torch_helpers import export_tool
from dm_control_torch.locomotion import arenas as tarenas
from dm_control_torch.locomotion import soccer as tsoccer
from dm_control_torch.locomotion import walkers as twalkers
from dm_control_torch.mjcf import compiler as tcompiler
from dm_control_torch.physics import model_io
from dm_control_torch.rl import golden as tgolden

GOLDENS = export_tool().LOCO_WALKER_GOLDENS
#: the soccer trees: ``soccer.load`` arguments and the nv they compile to
SOCCER_TREES = {
    "ant_1v1": ({"team_size": 1, "walker_type": "ant"}, 34),
    "ant_2v2": ({"team_size": 2, "walker_type": tsoccer.WalkerType.ANT}, 62),
    "humanoid_1v1": ({"team_size": 1, "walker_type": "humanoid"}, 130),
    "humanoid_2v2": ({"team_size": 2,
                      "walker_type": tsoccer.WalkerType.HUMANOID}, 254),
    "boxhead_10v10": ({"team_size": 10}, 166),
}
#: the fixed pitch of the hooks' matches
PITCH = (12, 9)


def _jax_lib():
    from dm_control_tpu.locomotion import arenas, walkers
    from dm_control_tpu.locomotion.arenas import padded_room
    from dm_control_tpu.locomotion.walkers import rescale, scaled_actuators

    return types.SimpleNamespace(
        arenas=arenas, walkers=walkers, padded_room=padded_room,
        rescale=rescale, scaled_actuators=scaled_actuators)


def _jax_soccer(**kwargs):
    """The JAX ``soccer.load``'s environment arguments (no compile), a
    ``WalkerType`` of the port given by its name."""
    walker_type = kwargs.get("walker_type")
    if isinstance(walker_type, tsoccer.WalkerType):
        kwargs["walker_type"] = walker_type.name.lower()
    return lhost._jax_soccer(**kwargs)


PORT = types.SimpleNamespace(
    arenas=tarenas, walkers=twalkers, padded_room=tarenas.padded_room,
    rescale=twalkers.rescale, scaled_actuators=twalkers.scaled_actuators)


def _other_tree(lib, which):
    """An arena with a walker that no soccer match builds."""
    w = lib.walkers
    if which == "padded_room_ant":
        room = lib.padded_room.PaddedRoom(
            room_size=3, num_objects=2,
            random_state=np.random.RandomState(5))
        arena = lib.arenas.MazeWithTargets(room, xy_scale=1.5)
        walker = w.Ant()
    else:
        arena = lib.arenas.Floor(size=(4, 4))
        if which == "rescaled_humanoid":
            walker = w.CMUHumanoidPositionControlled()
            lib.rescale.rescale_humanoid(walker, 0.8, 0.9, mass=40.0)
        else:  # an ant on scaled position and velocity actuators
            walker = w.Ant(name="scaled")
            joints = [j for j in walker.mjcf_model.iter()
                      if j.tag == "joint" and j.get("name")]
            for joint in joints[:4]:
                lib.scaled_actuators.add_position_actuator(
                    joint, (-0.5, 0.7), kp=30.0, name=f"p_{joint.get('name')}")
            for joint in joints[4:6]:
                lib.scaled_actuators.add_velocity_actuator(
                    joint, (-2.0, 2.0), ctrlrange=(-3, 3), kv=5.0,
                    name=f"v_{joint.get('name')}")
    walker.create_root_joints(arena.attach(walker))
    return arena


@pytest.mark.parametrize("tree", list(SOCCER_TREES) + [
    "padded_room_ant", "rescaled_humanoid", "scaled_actuators_ant"])
def test_tree_compiles_like_jax(tree):
    """The port's compiler on the port's tree equals the JAX compiler on
    the JAX tree, every leaf bit for bit."""
    import jax.numpy as jnp

    from dm_control_tpu.mjcf import compiler as jcompiler

    if tree in SOCCER_TREES:
        kwargs, nv = SOCCER_TREES[tree]
        task = tsoccer.load(device="cpu", **kwargs).task
        jtask = _jax_soccer(**kwargs).task
        root = lhost._timestep(task.root_entity.mjcf_model, task)
        jroot = lhost._timestep(jtask.root_entity.mjcf_model, jtask)
    else:
        nv = {"padded_room_ant": 14, "rescaled_humanoid": 62}.get(tree, 14)
        root, jroot = (_other_tree(lib, tree).mjcf_model
                       for lib in (PORT, _jax_lib()))
    model = tcompiler._Compiler(root).compile()
    model_io_tests._assert_same(model, model_io.from_jax_model(
        jcompiler._Compiler(jroot, jnp.float64).compile()))
    assert model.nv == nv


def test_walkers_match_jax():
    """The ant's root, end effectors and observable joints; the soccer
    humanoid's walker id, jersey geoms and refusals, as JAX's."""
    from dm_control_tpu.locomotion.soccer import humanoid as jhumanoid
    from dm_control_tpu.locomotion.walkers import ant as jant

    ant, jant_ = twalkers.Ant(name="a"), jant.Ant(name="a")
    for attr in ("root_body_name", "end_effector_body_names",
                 "observable_joint_names"):
        assert getattr(ant, attr) == getattr(jant_, attr), attr
    # the JAX package's ant looks for bodies named "ankle", where the
    # model's lowest segments are "*_foot": none, as there
    assert ant.end_effector_body_names == ()
    assert len(ant.observable_joint_names) == 8
    kw = dict(name="home1", marker_rgba=[0.1, 0.2, 0.3, 1.0], walker_id=1,
              visual=tsoccer.Humanoid.Visual.JERSEY)
    h = tsoccer.Humanoid(**kw)
    jkw = dict(kw, visual=jhumanoid.Humanoid.Visual.JERSEY)
    jh = jhumanoid.Humanoid(**jkw)
    assert h.walker_id == jh.walker_id == 1
    assert [g.get("name") for g in h.marker_geoms] == [
        g.get("name") for g in jh.marker_geoms]
    assert len(h.marker_geoms) == 8
    for bad in (dict(walker_id=11), dict(walker_id=None),
                dict(marker_rgba=[1, 0, 0]), dict(visual="jersey")):
        for cls, visual in ((tsoccer.Humanoid, tsoccer.Humanoid.Visual),
                            (jhumanoid.Humanoid, jhumanoid.Humanoid.Visual)):
            args = {**kw, "visual": visual.JERSEY, **bad}
            with pytest.raises(ValueError):
                cls(**args)


def test_padded_room_matches_jax():
    """The room's layers after the same draws, and after ``regenerate``."""
    from dm_control_tpu.locomotion.arenas import padded_room as jroom

    rooms = [lib.PaddedRoom(room_size=4, num_objects=3,
                            random_state=np.random.RandomState(2),
                            num_agent_spawn_positions=2)
             for lib in (tarenas.padded_room, jroom)]
    for _ in range(2):
        assert rooms[0].entity_layer == rooms[1].entity_layer
        assert rooms[0].variations_layer == rooms[1].variations_layer
        assert rooms[0].width == rooms[1].width == 8
        for room in rooms:
            room.regenerate()


# -- host episodes against the JAX package's ---------------------------------


def _port_env(name):
    """The port's environment of a golden, as ``loco_env`` builds the JAX
    one (``rl.golden.SOCCER_EPISODES``)."""
    return tsoccer.load(**tgolden.SOCCER_EPISODES[name], device="cpu")


@pytest.mark.parametrize("name", GOLDENS)
def test_host_episode_matches_golden(name):
    """The recorded JAX episode replayed one control step at a time: the
    reset's draws exactly (qpos, the drawn pitch's geom sizes), every
    timestep within the golden gate (``-s`` prints the figures)."""
    gold = lhost._golden(name)
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


@pytest.mark.slow
@pytest.mark.parametrize("name", GOLDENS)
def test_host_golden_equals_what_jax_gives_now(name):
    gold = lhost._golden(name)
    fresh = export_tool().make_loco_env_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)


# -- the hooks at shared states ----------------------------------------------


class _SoccerLockstep(lex._Lockstep):
    """``_Lockstep`` for soccer: one reward per player."""

    def after_step(self):
        self.physics._ensure_clean()
        self.jphysics.sync()
        out = []
        for task, physics, rs in ((self.task, self.physics,
                                   self.env.random_state),
                                  (self.jtask, self.jphysics, self.jrs)):
            task.after_step(physics, rs)
            for entity in task.root_entity.iter_entities():
                entity.after_step(physics, rs)
            out.append((np.asarray(task.get_reward(physics), float).tolist(),
                        bool(task.should_terminate_episode(physics)),
                        float(task.get_discount(physics))))
        assert out[0] == out[1]
        self._compare()
        return out[0]


@pytest.mark.parametrize("walker_type,team_size", [("ant", 2),
                                                   ("humanoid", 1)])
def test_soccer_hooks_match_jax(walker_type, team_size):
    """The reset (the initializer's draws, redrawn while entities touch,
    each player's free root placed and turned), every observable, then
    the rewards, termination and discount at rest and with the ball in
    each goal."""
    kwargs = dict(team_size=team_size, walker_type=walker_type,
                  pitch_size=PITCH)
    run = _SoccerLockstep(
        tsoccer.load(random_state=lex.SEED, device="cpu", **kwargs),
        _jax_soccer(**kwargs).task)
    run.reset()
    physics = run.physics
    for p in run.task.players:  # a free root, upright at the reset
        quat = np.asarray(p.walker.get_pose(physics)[1])
        assert abs(np.linalg.norm(quat) - 1) < 1e-12
    players = 2 * team_size
    assert run.after_step() == ([0.0] * players, False, 1.0)
    ball = run.task.ball
    for goal, sign in ((run.task.arena.home_goal, -1),
                       (run.task.arena.away_goal, 1)):
        ball.set_pose(physics, np.asarray(goal.mid))
        physics.forward()
        rewards, terminate, discount = run.after_step()
        home = [sign] * team_size
        assert rewards == [float(r) for r in home + [-r for r in home]]
        assert terminate and discount == 0.0
