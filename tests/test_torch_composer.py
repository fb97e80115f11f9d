"""The port's composer host path against the JAX package's, on the CPU.

- The scenarios of ``tests/test_composer.py`` on both packages side by
  side: a ball dropped by a composer task (``Floor`` arena, a free entity,
  an enabled observable) through ``composer.Environment``: the hook order,
  every step's reward and observation within ``ATOL`` of the JAX
  episode's; attachment prefixing and detach; observable options.
- The scheduler scenarios of ``tests/test_observation.py`` through the
  port's ``Updater`` and ``Buffer`` against the JAX package's, with
  intervals, delays and a corruptor drawn from ``numpy.random``
  RandomStates of one seed: results equal, and each RandomState left in
  the same state (the draws are made in the same order).
- The environment's own paths: ``EpisodeInitializationError`` retries,
  a diverged step absorbed as the episode's end, a camera observable
  rendering through ``physics.render``.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from dm_control_torch import composer as tcomposer
from dm_control_torch.composer import arena as tarena
from dm_control_torch.composer.observation import obs_buffer as tbuffer
from dm_control_torch.composer.observation import observable as tobservable
from dm_control_torch.composer.observation import updater as tupdater
from dm_control_torch.mjcf import element as telement
from dm_control_torch.physics.physics import PhysicsError
from dm_control_tpu import composer as jcomposer
from dm_control_tpu.composer import arena as jarena
from dm_control_tpu.composer.observation import obs_buffer as jbuffer
from dm_control_tpu.composer.observation import observable as jobservable
from dm_control_tpu.composer.observation import updater as jupdater
from dm_control_tpu.mjcf import element as jelement

#: largest |port - JAX| of a reward or an observation of the dropped ball
ATOL = 1e-9

_PACKAGES = {
    "torch": (tcomposer, tarena, tobservable, telement),
    "jax": (jcomposer, jarena, jobservable, jelement),
}


def _drop_task(package, **task_kwargs):
    """``tests/test_composer.py``'s Ball and DropTask, built from the
    package's composer classes."""
    composer, arena, observable, element = _PACKAGES[package]

    class Ball(composer.Entity):
        def _build(self, name="ball"):
            self._mjcf_root = element.Element("mujoco", {"model": name})
            wb = self._mjcf_root.add("worldbody")
            body = wb.add("body", name="root")
            body.add("geom", name="sphere", type="sphere", size="0.1",
                     mass="1")

        def _build_observables(self):
            obs = composer.Observables(self)
            obs.add_observable("position", observable.Generic(
                lambda phys: phys.named_field(
                    "xpos", self.attachment_frame.get("name"))))
            return obs

    class DropTask(composer.Task):
        def __init__(self, init_failures=0, launch=None):
            self._arena = arena.Floor()
            self._ball = Ball()
            self._arena.add_free_entity(self._ball)
            self._ball.observables.enable_all()
            self.set_timesteps(0.02, 0.002)
            self.hook_log = []
            self._init_failures = init_failures
            self._launch = launch

        @property
        def root_entity(self):
            return self._arena

        def initialize_episode(self, physics, random_state):
            self.hook_log.append("initialize_episode")
            if self._init_failures:
                self._init_failures -= 1
                raise composer.environment.EpisodeInitializationError()
            self._ball.set_pose(physics, position=[0, 0, 1.0])
            if self._launch is not None:
                self._ball.set_velocity(physics, velocity=self._launch)

        def before_step(self, physics, action, random_state):
            self.hook_log.append("before_step")
            super().before_step(physics, action, random_state)

        def after_step(self, physics, random_state):
            self.hook_log.append("after_step")

        def get_reward(self, physics):
            pos, _ = self._ball.get_pose(physics)
            return float(pos[2])

    return DropTask(**task_kwargs)


def _port_env(task, **kwargs):
    return tcomposer.Environment(task, device="cpu", **kwargs)


def _episode(env):
    steps = [env.reset()]
    while not steps[-1].last():
        steps.append(env.step(np.zeros(0)))
    return steps


def test_episode_mechanics_match_jax():
    """The dropped ball's episode: 25 control steps of 10 substeps, the
    hooks in the reference's order, rewards and observations of every step
    as the JAX episode's."""
    port = _port_env(_drop_task("torch"), time_limit=0.5, random_state=1)
    jax_env = jcomposer.Environment(_drop_task("jax"), time_limit=0.5,
                                    random_state=1)
    ours, theirs = _episode(port), _episode(jax_env)
    assert len(ours) == len(theirs) == 26
    assert [int(t.step_type) for t in ours] == \
        [int(t.step_type) for t in theirs]
    assert port.task.hook_log == jax_env.task.hook_log
    assert port.task.hook_log[:3] == ["initialize_episode", "before_step",
                                      "after_step"]
    rewards = [t.reward for t in ours[1:]]
    np.testing.assert_allclose(rewards, [t.reward for t in theirs[1:]],
                               rtol=0, atol=ATOL)
    for a, b in zip(ours, theirs):
        assert list(a.observation) == list(b.observation) == \
            ["ball/position"]
        np.testing.assert_allclose(a.observation["ball/position"],
                                   np.asarray(b.observation["ball/position"]),
                                   rtol=0, atol=ATOL)
    assert rewards[-1] < rewards[0]  # the ball fell ...
    assert abs(rewards[-1] - 0.1) < 0.02  # ... and rests on the floor
    assert port.physics.model.device.type == "cpu"
    assert port.observation_spec()["ball/position"].shape == (3,)


@pytest.mark.parametrize("package", _PACKAGES)
def test_attachment_prefixing(package):
    composer, arena, _, _ = _PACKAGES[package]
    task = _drop_task(package)
    floor, ball = task.root_entity, task._ball
    # single-root-body entities collapse into their root (no massless
    # wrapper body)
    assert ball.attachment_frame.get("name") == "ball/root"
    assert ball.attachment_frame.children[0].tag == "freejoint"
    assert ball.attachment_frame.children[0].get("name") == "ball/root_root"
    names = [e.get("name") for e in floor.mjcf_model.iter() if e.get("name")]
    assert names == ["groundplane", "ball/root", "ball/root_root",
                     "ball/sphere"]
    assert ball.parent is floor
    assert list(floor.iter_entities()) == [floor, ball]
    assert list(task.observables) == ["ball/position"]
    ball.detach()
    assert ball.parent is None and list(floor.iter_entities()) == [floor]
    with pytest.raises(RuntimeError):
        ball.detach()
    with pytest.raises(ValueError, match="duplicate"):  # one namescope
        other = _drop_task(package)._ball
        floor.attach(other)
        floor.attach(other)


@pytest.mark.parametrize("package", _PACKAGES)
def test_observable_options(package):
    generic = _PACKAGES[package][2].Generic
    obs = generic(lambda p: np.zeros(3), update_interval=2, buffer_size=4)
    assert obs.update_interval == 2
    obs.configure(delay=1, aggregator="mean")
    assert obs.delay == 1
    np.testing.assert_array_equal(obs.aggregator(np.arange(6.0).reshape(
        3, 2)), [2.0, 3.0])
    assert not obs.enabled
    obs.enabled = True
    assert obs.enabled
    with pytest.raises(KeyError):
        obs.configure(colour="red")


def test_reset_retries_after_initialization_errors():
    task = _drop_task("torch", init_failures=2)
    with pytest.raises(tcomposer.EpisodeInitializationError):
        _port_env(task, max_reset_attempts=2).reset()
    task = _drop_task("torch", init_failures=2)
    ts = _port_env(task, max_reset_attempts=3).reset()
    assert ts.first() and task.hook_log == ["initialize_episode"] * 3


def test_diverged_step_ends_the_episode():
    """A step that diverges raises ``PhysicsError``, or with
    ``raise_exception_on_physics_error=False`` ends the episode with reward
    and discount 0, and the next step starts a new one."""
    launch = [0.0, 0.0, 1e12]
    with pytest.raises(PhysicsError):
        env = _port_env(_drop_task("torch", launch=launch))
        env.reset()
        env.step(np.zeros(0))
    env = _port_env(_drop_task("torch", launch=launch),
                    raise_exception_on_physics_error=False)
    env.reset()
    ts = env.step(np.zeros(0))
    assert ts.last() and ts.reward == 0.0 and ts.discount == 0.0
    assert env.step(np.zeros(0)).first()


def test_camera_observable_does_not_render():
    """Named for what it checked before the port rendered: the observable
    now renders its camera through ``physics.render``."""
    from dm_control_torch.physics.physics import Physics

    physics = Physics.from_xml_string(
        '<mujoco><worldbody><geom type="plane" size="2 2 .1"/>'
        '<geom type="sphere" pos="0 0 .5" size=".2" rgba="1 0 0 1"/>'
        '<camera name="front" pos="0 -2 .5" xyaxes="1 0 0 0 0 1"/>'
        '</worldbody></mujoco>', device="cpu")
    physics.forward()
    cam = tobservable.MujocoCamera("front", height=8, width=12)
    assert cam.array_spec.shape == (8, 12, 3)
    img = cam(physics)
    assert img.shape == (8, 12, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, physics.render(8, 12, "front"))
    depth = tobservable.MujocoCamera("front", height=9, width=13,
                                     depth=True)(physics)
    assert depth.shape == (9, 13, 1) and depth.dtype == np.float32
    # the centre ray meets the sphere's front, 2 - 0.2 m away
    assert depth[4, 6, 0] == pytest.approx(1.8, abs=1e-5)


# -- the observation scheduler -------------------------------------------------


class _DeterministicSequence:

    def __init__(self, sequence):
        self._iter = itertools.cycle(sequence)

    def __call__(self, random_state=None):
        del random_state
        return next(self._iter)


class _FakePhysics:
    """Counter-valued observables (reference fake_physics.py:25)."""

    def __init__(self):
        self._step_counter = 0

    def step(self):
        self._step_counter += 1

    def twice(self):
        return 2 * self._step_counter

    def repeated(self):
        return [self._step_counter, self._step_counter]

    def sqrt(self):
        return np.sqrt(self._step_counter)

    def matrix(self):
        return [[self._step_counter] * 3] * 2

    def time(self):
        return self._step_counter


def _noisy(value, random_state):
    return np.asarray(value, float) + random_state.normal(
        size=np.shape(value))


def _observables(package, scenario):
    """``tests/test_observation.py``'s observables of ``scenario``, enabled,
    built from the package's ``Generic``; "drawn" adds intervals and
    delays drawn from the RandomState the updater is given, and a
    corruptor."""
    generic = _PACKAGES[package][2].Generic
    if scenario == "intervals":
        out = {
            "twice": generic(_FakePhysics.twice),
            "repeated": generic(_FakePhysics.repeated, update_interval=5,
                                buffer_size=5),
            "matrix": generic(_FakePhysics.matrix, update_interval=3,
                              delay=1),
            "sqrt": generic(_FakePhysics.sqrt, update_interval=7,
                            buffer_size=3, delay=2),
        }
    elif scenario == "variable":
        out = {"time": generic(
            lambda p: p.time(), buffer_size=3,
            update_interval=_DeterministicSequence([3, 2, 3, 3, 4, 1, 4]),
            delay=_DeterministicSequence([3, 5, 2, 5, 1, 2, 4]))}
    else:
        out = {
            "time": generic(
                lambda p: p.time(), buffer_size=4,
                update_interval=lambda rs: int(rs.randint(1, 4)),
                delay=lambda rs: int(rs.randint(0, 3))),
            "noisy": generic(_FakePhysics.repeated, corruptor=_noisy,
                             aggregator="mean", buffer_size=2),
            "twice": generic(_FakePhysics.twice, update_interval=2),
        }
    for obs in out.values():
        obs.enabled = True
    return out


def _run_updater(package, scenario, n_sub, control_steps):
    updater = {"torch": tupdater, "jax": jupdater}[package].Updater
    physics = _FakePhysics()
    random_state = np.random.RandomState(7)
    upd = updater(_observables(package, scenario), n_sub)
    upd.reset(physics=physics, random_state=random_state)
    out = [upd.get_observation()]
    for _ in range(control_steps):
        upd.prepare_for_next_control_step()
        for _ in range(n_sub):
            physics.step()
            upd.update(physics, random_state)
        out.append(upd.get_observation())
    return out, random_state, upd


@pytest.mark.parametrize("scenario,n_sub", [("intervals", 5),
                                            ("variable", 10), ("drawn", 4)])
def test_updater_matches_jax(scenario, n_sub):
    ours, ours_rs, upd = _run_updater("torch", scenario, n_sub, 30)
    theirs, theirs_rs, _ = _run_updater("jax", scenario, n_sub, 30)
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    np.testing.assert_array_equal(ours_rs.get_state()[1],
                                  theirs_rs.get_state()[1])
    assert ours_rs.get_state()[2] == theirs_rs.get_state()[2]
    spec = upd.observation_spec()
    assert list(spec) == list(ours[-1])
    if scenario == "intervals":  # tests/test_observation.py's expectation
        t = 30 * n_sub
        end = 3 * math.floor((t - 1) / 3)
        np.testing.assert_array_equal(ours[-1]["matrix"], [[end] * 3] * 2)
        assert spec["repeated"].shape == (5, 2)
    if scenario == "variable":
        np.testing.assert_array_equal(ours[-1]["time"],
                                      280 + np.array([8, 15, 16]))


@pytest.mark.parametrize("case", ["out_of_order", "pads", "planned_drop"])
def test_buffer_matches_jax(case):
    out = {}
    for package, module in (("torch", tbuffer), ("jax", jbuffer)):
        if case == "out_of_order":
            buf = module.Buffer(buffer_size=3, shape=(), dtype=float)
            buf.insert(0, 3, 0.0)   # arrives at 3
            buf.insert(3, 5, 3.0)   # arrives at 8
            buf.insert(5, 2, 5.0)   # arrives at 7: before the one made at 3
            out[package] = [buf.read(t) for t in (2, 7, 10)]
        elif case == "pads":
            buf = module.Buffer(buffer_size=2, shape=(2,), dtype=float,
                                pad_value=-1.0)
            buf.insert(0, 4, [7.0, 8.0])
            out[package] = [buf.read(t) for t in (0, 3, 4)]
        else:
            buf = module.Buffer(buffer_size=1, shape=(), dtype=float)
            schedule = [(1, 0), (2, 0), (3, 0), (4, 0), (5, 0)]
            buf.drop_unobserved_upcoming_items(schedule, read_interval=5)
            out[package] = schedule
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if case == "out_of_order":
        np.testing.assert_array_equal(out["torch"][-1], [0.0, 5.0, 3.0])
    if case == "planned_drop":
        assert out["torch"] == [(5, 0)]
    with pytest.raises(ValueError):
        tbuffer.Buffer(1, (), float).insert(0, -1, 0.0)


def test_environment_defaults_to_the_card():
    env = _port_env(_drop_task("torch"))
    assert env.physics.model.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcomposer.Environment(_drop_task("torch"))
