"""The port's single environment (``suite.load`` -> ``rl.control.
Environment``) against the JAX package's, in float64 on the CPU.

Live: pendulum:swingup and cartpole:swingup through both packages'
``suite.load`` with the same seed and actions, a reset and 10 steps (and,
with a short ``time_limit``, the LAST step at the limit with discount 1
and the reset after it): observations and rewards within 1e-10 (the same
float64 expressions, summed in another order), step types and discounts
equal; lqr's model and episodes drawn from one RandomState as the JAX
package draws them; each of the other 44 tasks loads, resets and steps.
The episode goldens (``tools/export_torch_assets.py
env_golden:...``: a reset and 5 steps of six tasks that reach the settle
loop, the rejection loop, acceleration-stage sensors at the reset and the
host draws) replay through the port under the golden gate
(``rl/golden.py::episode_gate``: ``gate_figures`` at every timestep, and
cheetah's settled warm start at its reset, a recorded miss, against the
episode's scale); ``-s`` prints both figures.  ``slow``: each golden
file still equals a fresh JAX episode.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import export_tool
from dm_control_torch import suite as tsuite
from dm_control_torch.rl import golden

ATOL = 1e-10
SEED = 11


def _actions(spec, n, seed=1):
    rng = np.random.RandomState(seed)
    low = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
    high = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
    return [rng.uniform(low, high) for _ in range(n)]


def _assert_timesteps_close(t_ts, j_ts, what):
    assert int(t_ts.step_type) == int(j_ts.step_type), what
    assert (t_ts.reward is None) == (j_ts.reward is None), what
    assert (t_ts.discount is None) == (j_ts.discount is None), what
    if j_ts.reward is not None:
        assert abs(t_ts.reward - float(j_ts.reward)) <= ATOL, what
        assert t_ts.discount == float(j_ts.discount), what
    assert list(t_ts.observation) == list(j_ts.observation), what
    for k, v in j_ts.observation.items():
        np.testing.assert_allclose(t_ts.observation[k], np.asarray(v),
                                   rtol=0, atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("domain,task", [("pendulum", "swingup"),
                                         ("cartpole", "swingup")])
def test_live_episode_matches_jax(domain, task):
    """Specs, a reset and 10 steps, then an episode cut by ``time_limit``
    (LAST at the limit with discount 1, a reset on the next step), against
    the JAX package's environment, and ``observation_spec()`` before the
    first reset leaves the episodes' RandomState as it was."""
    from dm_control_tpu import suite as jsuite

    kwargs = {"random": SEED}
    jenv = jsuite.load(domain, task, task_kwargs=kwargs)
    tenv = tsuite.load(domain, task, task_kwargs=kwargs, device="cpu")
    before = tenv.random_state.get_state()
    t_spec, j_spec = tenv.observation_spec(), jenv.observation_spec()
    after = tenv.random_state.get_state()
    np.testing.assert_array_equal(before[1], after[1])
    assert before[2:] == after[2:]
    assert list(t_spec) == list(j_spec)
    for k, v in j_spec.items():
        assert (t_spec[k].shape, t_spec[k].dtype, t_spec[k].name) == \
            (v.shape, v.dtype, v.name), k
    ta, ja = tenv.action_spec(), jenv.action_spec()
    assert (ta.shape, ta.dtype, ta.name) == (ja.shape, ja.dtype, ja.name)
    np.testing.assert_array_equal(ta.minimum, ja.minimum)
    np.testing.assert_array_equal(ta.maximum, ja.maximum)
    assert tenv.control_timestep() == jenv.control_timestep()

    actions = _actions(ja, 10)
    _assert_timesteps_close(tenv.reset(), jenv.reset(), "reset")
    for i, a in enumerate(actions):
        _assert_timesteps_close(tenv.step(a), jenv.step(a), f"step {i}")

    # an episode of 4 control steps: LAST at the limit, then a new episode
    limit = 4 * tenv.control_timestep()
    kwargs = dict(random=SEED + 1, time_limit=limit)
    jenv = jsuite.load(domain, task, task_kwargs=kwargs)
    tenv = tsuite.load(domain, task, task_kwargs=kwargs, device="cpu")
    _assert_timesteps_close(tenv.reset(), jenv.reset(), "reset")
    kinds = []
    for i, a in enumerate(actions[:6]):
        t_ts = tenv.step(a)
        _assert_timesteps_close(t_ts, jenv.step(a), f"limited step {i}")
        kinds.append(int(t_ts.step_type))
    assert kinds == [1, 1, 1, 2, 0, 1]
    assert t_ts.discount == 1.0


def test_lqr_model_and_episodes_share_the_seed():
    """lqr's model draws from the episodes' RandomState first (as the JAX
    package's ``get_model``, which ``tests/test_torch_lqr.py`` holds
    ``seeded_fields`` to), and the episodes continue that stream."""
    from dm_control_torch.rl.control import RandomContext
    from dm_control_torch.suite import lqr as tlqr

    rs = np.random.RandomState(SEED)
    fields = tlqr.seeded_fields(2, rs)
    env = tsuite.load("lqr", "lqr_2_1", task_kwargs={"random": SEED},
                      device="cpu")
    m = env.physics.model
    np.testing.assert_array_equal(m.jnt_stiffness.numpy(),
                                  fields["jnt_stiffness"])
    qpos, _, _ = env.task.init(m, m.qpos0[None].clone(),
                               torch.zeros(1, m.nv, dtype=m.dtype),
                               RandomContext.numpy(rs, "cpu", m.dtype), {})
    env.reset()
    np.testing.assert_array_equal(env.physics.data.qpos.numpy(),
                                  qpos[0].numpy())


#: tasks whose episodes the goldens and the live tests already run
_ELSEWHERE = {("pendulum", "swingup")} | set(export_tool().ENV_GOLDENS)
_OTHER_TASKS = [t for t in tsuite.ALL_TASKS if t not in _ELSEWHERE]


@pytest.mark.parametrize("domain,task", _OTHER_TASKS,
                         ids=[f"{d}-{t}" for d, t in _OTHER_TASKS])
def test_load_serves_every_task(domain, task):
    """``load`` on the CPU in float64 (the 44 tasks no other test here
    runs): the spec names the reset's observations, and a step is MID
    with finite values."""
    env = tsuite.load(domain, task, task_kwargs={"random": 5},
                      device="cpu")
    spec = env.observation_spec()
    ts = env.reset()
    assert ts.first() and ts.reward is None and ts.discount is None
    assert [(k, v.shape, v.dtype) for k, v in spec.items()] == \
        [(k, v.shape, v.dtype) for k, v in ts.observation.items()]
    ts = env.step(_actions(env.action_spec(), 1)[0])
    assert ts.mid() and ts.discount == 1.0 and np.isfinite(ts.reward)
    assert all(np.isfinite(v).all() for v in ts.observation.values())


def test_load_defaults_to_the_card():
    """``load`` without a device asks for CUDA: it raises where there is
    none, and names the way to the CPU."""
    if torch.cuda.is_available():
        env = tsuite.load("pendulum", "swingup")
        assert env.physics.model.device.type == "cuda"
        assert env.physics.model.dtype == torch.float64
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsuite.load("pendulum", "swingup")


def test_environment_kwargs_as_jax():
    """``environment_kwargs`` reach the Environment (its control timestep
    here), a domain's own control timestep cannot be given twice, and
    three_poles serves any pole count (its model compiled by the port)."""
    env = tsuite.load("pendulum", "swingup", device="cpu",
                      environment_kwargs={"control_timestep": 0.04})
    assert env.control_timestep() == 0.04
    assert env._n_sub_steps == 2
    with pytest.raises(TypeError):
        tsuite.load("fish", "swim", device="cpu",
                    environment_kwargs={"control_timestep": 0.08})
    env = tsuite.load("cartpole", "three_poles", device="cpu",
                      task_kwargs={"num_poles": 2, "random": 0})
    assert env.physics.model.nq == 3
    env = tsuite.load("cartpole", "three_poles", device="cpu",
                      task_kwargs={"num_poles": 4, "random": 0})
    assert env.physics.model.nq == 5


def _gold(name):
    with np.load(export_tool().env_golden_path(name),
                 allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


_GOLDENS = [export_tool().env_golden_name(d, t)
            for d, t in export_tool().ENV_GOLDENS]


@pytest.mark.parametrize("pair", export_tool().ENV_GOLDENS, ids=_GOLDENS)
def test_env_golden(pair):
    """The reset and 5 steps of the recorded episode: every timestep within
    the golden gate, step types and discounts equal."""
    name = export_tool().env_golden_name(*pair)
    gold = _gold(name)
    env = tsuite.load(*pair, task_kwargs={"random": export_tool().ENV_SEED},
                      device="cpu")
    errs = golden.episode_errors(env, gold)
    figures, ok = golden.episode_gate(errs, gold, name)
    for t, (rest, rel) in enumerate(figures):
        print(f"\n{name} t={t}: gate: rest {rest:.3e}, qacc_warmstart "
              f"{rel:.3e} of its scale")
        assert rest <= golden.ABS_GATE, (t, rest, max(errs[t],
                                                      key=errs[t].get))
        if (name, t) in golden.EPISODE_WARMSTART_MISSES:
            assert rel > golden.REL_GATE  # still the recorded miss
        else:
            assert rel <= golden.REL_GATE, (t, rel)
        assert errs[t]["step_type"] == 0, t
        assert errs[t].get("discount", 0) == 0, t
    assert ok


@pytest.mark.slow
@pytest.mark.parametrize("pair", export_tool().ENV_GOLDENS, ids=_GOLDENS)
def test_env_golden_equals_fresh_jax(pair):
    name = export_tool().env_golden_name(*pair)
    gold = _gold(name)
    fresh = export_tool().make_env_golden(*pair)
    assert sorted(fresh) == sorted(gold)
    for k, v in fresh.items():
        np.testing.assert_array_equal(v, gold[k], err_msg=k)
