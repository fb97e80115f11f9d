"""The port's suite layer beside the JAX package's, on the CPU: the task
sets and the unknown-name errors, the four wrappers (a noisy pendulum
episode equal to the JAX one within 1e-10, since the noise comes from the
same RandomState), ``utils/transformations`` on seeded inputs (equal to
1e-12), ``parse_amc.convert`` on a synthetic clip (to 1e-12), and the
port's dm_env types field for field against ``dm_env``'s.
"""

import collections

import numpy as np
import pytest
import torch

from _torch_helpers import jax_model_from_asset
from dm_control_torch import suite as tsuite
from dm_control_torch.rl import environment, specs
from dm_control_torch.suite.wrappers import (
    action_noise, action_scale, mujoco_profiling,
)


def test_task_sets_equal_jax():
    from dm_control_tpu import suite as jsuite

    for name in ("ALL_TASKS", "BENCHMARKING", "EASY", "HARD", "EXTRA",
                 "TASKS_BY_DOMAIN", "BENCHMARKING_BY_DOMAIN"):
        assert getattr(tsuite, name) == getattr(jsuite, name), name
    for d in tsuite.DOMAINS:
        assert tsuite.DOMAINS[d].TASKS.tags() == \
            jsuite._DOMAINS[d].SUITE.tags(), d
        for tag in tsuite.DOMAINS[d].TASKS.tags():
            assert list(tsuite.DOMAINS[d].TASKS.tagged(tag)) == \
                list(jsuite._DOMAINS[d].SUITE.tagged(tag)), (d, tag)


@pytest.mark.parametrize("domain,task", [("nope", "run"),
                                         ("cartpole", "nope")])
def test_unknown_names_raise_as_jax(domain, task):
    from dm_control_tpu import suite as jsuite

    with pytest.raises(ValueError) as jerr:
        jsuite.load(domain, task)
    for load in (tsuite.load, tsuite.load_batch):
        with pytest.raises(ValueError) as terr:
            load(domain, task, device="cpu", dtype=torch.float64)
        assert str(terr.value) == str(jerr.value)


def _noisy_episode(suite, wrappers, steps, **load_kwargs):
    """A pendulum episode through action_noise, action_scale and
    mujoco_profiling (``wrappers``: the package's three modules)."""
    noise, scale, profiling = wrappers
    env = suite.load("pendulum", "swingup", task_kwargs={"random": 4},
                     **load_kwargs)
    env = profiling.Wrapper(scale.Wrapper(noise.Wrapper(env, scale=0.2),
                                          -2.0, 2.0))
    out = [env.reset()]
    for a in np.linspace(-2, 2, steps):
        out.append(env.step(np.array([a])))
    return env, out


def test_wrappers_match_jax():
    """Noise (from the episode RandomState), rescaled actions and the
    profiling observation: the same episode as the JAX wrappers give."""
    from dm_control_tpu import suite as jsuite
    from dm_control_tpu.suite.wrappers import action_noise as jnoise
    from dm_control_tpu.suite.wrappers import action_scale as jscale
    from dm_control_tpu.suite.wrappers import mujoco_profiling as jprof

    tenv, t_out = _noisy_episode(
        tsuite, (action_noise, action_scale, mujoco_profiling), 8,
        device="cpu")
    jenv, j_out = _noisy_episode(jsuite, (jnoise, jscale, jprof), 8)
    for t_ts, j_ts in zip(t_out, j_out):
        assert int(t_ts.step_type) == int(j_ts.step_type)
        if j_ts.reward is not None:
            assert abs(t_ts.reward - float(j_ts.reward)) <= 1e-10
        assert list(t_ts.observation) == list(j_ts.observation)
        for k, v in j_ts.observation.items():
            np.testing.assert_allclose(t_ts.observation[k], np.asarray(v),
                                       rtol=0, atol=1e-10, err_msg=k)
    ts, js = tenv.action_spec(), jenv.action_spec()
    assert (ts.shape, ts.dtype, ts.name) == (js.shape, js.dtype, js.name)
    np.testing.assert_array_equal(ts.minimum, js.minimum)
    assert [(v.shape, v.dtype, v.name)
            for v in tenv.observation_spec().values()] == \
        [(v.shape, v.dtype, v.name)
         for v in jenv.observation_spec().values()]
    assert tenv.reward_spec() == specs.Array((), float, "reward")
    np.testing.assert_array_equal(tenv.random_state.get_state()[1],
                                  jenv.random_state.get_state()[1])
    with pytest.raises(ValueError, match="finite action bounds"):
        action_noise.Wrapper(tsuite.load("manipulator", "bring_ball",
                                         device="cpu"))


def test_transformations_match_jax():
    from dm_control_tpu.utils import transformations as jtr
    from dm_control_torch.utils import transformations as ttr

    rng = np.random.RandomState(0)
    quats = rng.randn(5, 4)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    vecs, angles = rng.randn(5, 3), rng.uniform(-3, 3, 5)
    mats = np.stack([jtr.quat_to_mat(q)[:3, :3] for q in quats])
    calls = [("quat_conj", (quats[0],)), ("quat_inv", (quats[1],)),
             ("quat_mul", (quats[0], quats[1])),
             ("quat_diff", (quats[2], quats[3])), ("quat_log", (quats[4],)),
             ("quat_dist", (quats[0], quats[3])),
             ("quat_rotate", (quats[1], vecs[0])),
             ("quat_to_axisangle", (quats[2],)), ("quat_to_mat", (quats[3],)),
             ("mat_to_quat", (mats[0],)), ("rotation_x_axis", (angles[0],)),
             ("rotation_y_axis", (angles[1], True)),
             ("rotation_z_axis", (angles[2],)),
             ("rotation_matrix_2d", (angles[3],)),
             ("euler_to_quat", (vecs[1], "XYZ")),
             ("euler_to_rmat", (vecs[2], "ZXZ")),
             ("pos_to_hmat", (vecs[3],)),
             ("hmat_inv", (jtr.quat_to_mat(quats[4]),))]
    calls += [("rmat_to_euler", (mats[1], o))
              for o in ("XYZ", "XYX", "ZYX", "XZY", "YZX", "ZXY", "YXZ")]
    calls += [("quat_to_euler", (quats[2], o)) for o in ("XYZ", "ZYX")]
    for name, args in calls:
        np.testing.assert_allclose(
            np.asarray(getattr(ttr, name)(*args)),
            np.asarray(getattr(jtr, name)(*args)), rtol=0, atol=1e-12,
            err_msg=name)


def _clip(path):
    """A synthetic .amc clip of 12 frames of every CMU joint (the clip of
    tests/test_scripts.py::test_parse_amc_against_oracle)."""
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
    return str(path)


def test_parse_amc_matches_jax(tmp_path):
    """``convert`` reads ``physics.model`` only: the JAX one gets a stand-in
    whose model is the JAX model built from the port's CMU asset (its
    suite.load compiles for minutes)."""
    from dm_control_tpu.suite.utils import parse_amc as jamc
    from dm_control_torch.physics.physics import Physics
    from dm_control_torch.suite import base as tbase
    from dm_control_torch.suite.utils import parse_amc as tamc

    fname = _clip(tmp_path / "clip.amc")
    tphys = Physics(tbase.load_model("humanoid_CMU", "cpu", torch.float64))
    jphys = collections.namedtuple("Stand", "model")(
        jax_model_from_asset("humanoid_CMU"))
    dt = float(tphys.model.opt.timestep)
    t, j = tamc.convert(fname, tphys, dt), jamc.convert(fname, jphys, dt)
    assert t.qpos.shape == (tphys.model.nq, len(t.time))
    for k in ("qpos", "qvel", "time"):
        np.testing.assert_allclose(getattr(t, k), getattr(j, k), rtol=0,
                                   atol=1e-12, err_msg=k)


def test_dm_env_types_equal_dm_env():
    import dm_env
    from dm_env import specs as dspecs

    assert [(s.name, int(s)) for s in environment.StepType] == \
        [(s.name, int(s)) for s in dm_env.StepType]
    for s in environment.StepType:
        d = dm_env.StepType(int(s))
        assert (s.first(), s.mid(), s.last()) == (d.first(), d.mid(),
                                                  d.last())
    assert environment.TimeStep._fields == dm_env.TimeStep._fields
    ts = environment.TimeStep(environment.StepType.LAST, 1.0, 0.5, {})
    dts = dm_env.TimeStep(dm_env.StepType.LAST, 1.0, 0.5, {})
    assert (ts.first(), ts.mid(), ts.last()) == (dts.first(), dts.mid(),
                                                  dts.last())
    a, da = specs.Array((2, 3), np.float32, "x"), \
        dspecs.Array((2, 3), np.float32, "x")
    assert (a.shape, a.dtype, a.name, repr(a)) == \
        (da.shape, da.dtype, da.name, repr(da))
    np.testing.assert_array_equal(a.generate_value(), da.generate_value())
    b = specs.BoundedArray((3,), np.float64, [-1, 0, 0], 2.0, "b")
    db = dspecs.BoundedArray((3,), np.float64, [-1, 0, 0], 2.0, "b")
    assert (b.shape, b.dtype, b.name, repr(b)) == \
        (db.shape, db.dtype, db.name, repr(db))
    np.testing.assert_array_equal(b.minimum, db.minimum)
    np.testing.assert_array_equal(b.maximum, db.maximum)
    np.testing.assert_array_equal(b.generate_value(), db.generate_value())
    assert b.replace(name="c").name == db.replace(name="c").name == "c"
    for bad in (np.zeros((3,), np.float32), np.array([3.0, 0, 0]),
                np.zeros(4)):
        with pytest.raises(ValueError) as t_err:
            b.validate(bad)
        with pytest.raises(ValueError) as d_err:
            db.validate(bad)
        assert str(t_err.value) == str(d_err.value)
    with pytest.raises(ValueError) as t_err:
        specs.BoundedArray((2,), float, [1, 1], [0, 0])
    with pytest.raises(ValueError) as d_err:
        dspecs.BoundedArray((2,), float, [1, 1], [0, 0])
    assert str(t_err.value) == str(d_err.value)
    env = tsuite.load("pendulum", "swingup", device="cpu")
    for name in ("reward_spec", "discount_spec"):
        assert repr(getattr(env, name)()) == \
            repr(getattr(dm_env.Environment, name)(env)), name
