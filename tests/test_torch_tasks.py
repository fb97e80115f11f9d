"""Every task of the port's domains other than humanoid against the JAX
package's task of the same name, in float64 on the CPU: ``before_step``,
the env layer's recompute after a step (the "vel" branch, and hopper's and
quadruped's "acc" branch), ``observation``, ``reward`` and ``termination``
on the same states.

The golden files step one task per domain; this file holds the other
tasks' branches (cartpole's sparse rewards and its two- and three-pole
observations, hopper's and walker's stand rewards, reacher's small target,
point_mass without its shuffled gains) to JAX numbers too.  The states of a
task are the port's own reset states of every task of the domain that has
the same model size, the model's ``qpos0`` (upright, for the poles) and the
domain's golden states, every other one at rest and the others with
velocities from a numpy seed; the model overrides are the task's own
reset's (escape's per-environment terrains too), the controls and, where
the model has them, the activations come from a numpy seed.  Every task
meets states that
it rewards differently (a sparse reward shows both its values).
Tolerance: 1e-10 absolute on observations and rewards (both sides compute
the same float64 expressions; they differ by summation order only);
termination flags are equal.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_helpers import golden
from dm_control_torch import suite as tsuite

#: the domains whose tasks tests/test_torch_finger.py and
#: tests/test_torch_manipulator.py run through this file's functions (their
#: files compile the JAX models anyway)
MANIPULATION = ("finger", "manipulator", "stacker")
#: the same for tests/test_torch_humanoid_cmu.py, tests/test_torch_lqr.py
#: and tests/test_torch_dog.py
ELSEWHERE = MANIPULATION + ("humanoid_CMU", "lqr", "dog")
TASKS = tuple(t for t in tsuite.ALL_TASKS
              if t[0] != "humanoid" and t[0] not in ELSEWHERE)
ATOL = 1e-10


def _env(domain, task, task_kwargs=None):
    return tsuite.load_batch(domain, task, device="cpu", dtype=torch.float64,
                             autoreset=False, task_kwargs=task_kwargs)


@functools.lru_cache(maxsize=None)
def _reset_qpos(domain, task, seed, task_kwargs=()):
    """qpos (2, nq) after the port's reset of two environments of
    ``task``, drawn with ``seed`` (the same for every task of the domain
    that is compared)."""
    state, _ = _env(domain, task, dict(task_kwargs) or None).reset(
        2, torch.Generator().manual_seed(seed))
    return state.data.qpos


def _states(domain, task, task_kwargs=None):
    """(env, qpos, qvel, model_diff, ctrl) as float64 tensors."""
    env = _env(domain, task, task_kwargs)
    m = env.model
    qpos = [m.qpos0.reshape(1, m.nq)]
    if not env.task.settle_steps:  # cheetah's reset is 200 steps: golden only
        for i, other in enumerate(tsuite.DOMAINS[domain].TASKS):
            if _env(domain, other, task_kwargs).model.nq == m.nq:
                qpos.append(_reset_qpos(domain, other, i, tuple(sorted(
                    (task_kwargs or {}).items()))))
    gold = golden(domain)
    if gold["reset_qpos"].shape[1] == m.nq:
        qpos += [torch.as_tensor(gold["reset_step_qpos"]),
                 torch.as_tensor(gold["contact_step_qpos"])]
    qpos = torch.cat(qpos)
    n = qpos.shape[0]
    rng = np.random.default_rng(n)
    qvel = torch.as_tensor(rng.normal(size=(n, m.nv)))
    qvel[::2] = 0.0  # every other state is at rest
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (n, m.nu)))
    if env.task.settle_steps:
        diff = env.task.initial_model_diff(m)
    else:
        diff = env.reset(n, torch.Generator().manual_seed(9))[0].model_diff
    _reward_state_0(domain, env, qpos, qvel, diff, ctrl)
    return env, qpos, qvel, diff, ctrl


def _data(env, qpos, qvel, diff, ctrl):
    """The port's (model, Data) as ``BatchEnv`` hands them to the task's
    reward after a step that ended at this state."""
    from dm_control_torch.rl.control import apply_model_diff

    n = qpos.shape[0]
    state = env.from_state(qpos, qvel, torch.zeros_like(qvel),
                           torch.zeros(n, dtype=qpos.dtype),
                           generator=torch.Generator().manual_seed(0),
                           model_diff=diff, act=_act(n, env.model.na))
    m = apply_model_diff(env.model, diff)
    d = env.task.before_step(m, env._unstrip(state.data), ctrl)
    state, obs = env._observe(state.replace(data=d))
    return m, state.data, obs


def _act(n, na):
    """Activations (n, na) from a seed, or None for a model without."""
    if not na:
        return None
    return torch.as_tensor(np.random.default_rng(na).uniform(-1, 1, (n, na)))


def _port(env, qpos, qvel, diff, ctrl):
    """(observation, reward, terminate, discount) and the Data they read."""
    m, d, obs = _data(env, qpos, qvel, diff, ctrl)
    terminate, discount = env.task.termination(m, d)
    return (obs, env.task.reward(m, d), terminate, discount), d


def _reward_state_0(domain, env, qpos, qvel, diff, ctrl):
    """Makes state 0 (``qpos0``, at rest) one that the domain's otherwise
    rarely met reward pays for: reacher's target under the finger,
    ball_in_cup's ball at the target, hopper moving forward, finger's
    spinner turning fast and its target under the tip, manipulator's prop
    on its target, a stacker box on the target."""
    m, d, _ = _data(env, qpos, qvel, diff, ctrl)
    names = m.names
    if domain == "finger":
        qvel[0, m.jnt_dofadr[names.joint["hinge"]]] = -20.0
        if "site_pos" in diff:  # the target is a world site
            xz = m.idx([0, 2])
            diff["site_pos"][0, names.site["target"], xz] = \
                d.site_xpos[0, names.site["tip"], xz]
    if domain in ("manipulator", "stacker"):
        prop, target = ("box0", "target") if domain == "stacker" else (
            env.task._object, env.task._target)
        if domain == "manipulator":  # turn the prop to the target's angle
            def angle(b):
                q = d.xquat[0, names.body[b]]
                return 2 * torch.atan2(q[2], q[0])
            qpos[0, m.jnt_qposadr[names.joint[prop + "_y"]]] += \
                angle(target) - angle(prop)
            m, d, _ = _data(env, qpos, qvel, diff, ctrl)
        gap = d.site_xpos[0, names.site[target]] \
            - d.site_xpos[0, names.site[prop]]
        qpos[0, m.jnt_qposadr[names.joint[prop + "_x"]]] += gap[0]
        qpos[0, m.jnt_qposadr[names.joint[prop + "_z"]]] += gap[2]
    if domain == "reacher":
        diff["geom_pos"][0, names.geom["target"], :2] = \
            d.geom_xpos[0, names.geom["finger"], :2]
    if domain == "ball_in_cup":
        gap = d.site_xpos[0, names.site["target"]] \
            - d.xpos[0, names.body["ball"]]
        qpos[0, m.jnt_qposadr[names.joint["ball_x"]]] += gap[0]
        qpos[0, m.jnt_qposadr[names.joint["ball_z"]]] += gap[2]
    if domain == "hopper":
        qvel[0, m.jnt_dofadr[names.joint["rootx"]]] = 3.0


def _jax(domain, task, qpos, qvel, diff, ctrl, env=None, task_kwargs=None,
         port_data=None):
    """The JAX task's (observation, reward, terminate, discount) at the
    states; ``env``: the JAX ``BatchEnv`` (default: the JAX suite's).
    With ``port_data`` (the port's Data after its observe) the JAX task
    reads that Data (``jax_data``) in place of running the JAX physics."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu import suite as jsuite
    from dm_control_tpu.physics.model import make_data
    from dm_control_tpu.rl.control import EnvState, apply_model_diff

    if env is None:
        env = jsuite.load_batch(domain, task, task_kwargs=task_kwargs,
                                autoreset=False)

    def outputs(m, d):
        terminate, discount = env.task.termination(m, d)
        return (env.task.observation(m, d), env.task.reward(m, d),
                jnp.asarray(terminate), jnp.asarray(discount, d.qpos.dtype))

    jdiff = {k: jnp.asarray(v.numpy()) for k, v in diff.items()}
    if port_data is not None:
        return jax.jit(jax.vmap(lambda d, diff: outputs(
            apply_model_diff(env.model, diff), d)))(
                jax_data(env.model, port_data), jdiff)

    act = _act(qpos.shape[0], env.model.na)
    act = jnp.zeros((qpos.shape[0], 0)) if act is None \
        else jnp.asarray(act.numpy())

    def one(qpos, qvel, act, diff, ctrl):
        m = apply_model_diff(env.model, diff)
        d = env.task.before_step(m, make_data(env.model).replace(
            qpos=qpos, qvel=qvel, act=act), ctrl)
        state, _ = env._observe(EnvState(
            data=d, model_diff=diff, rng=None,
            step_count=jnp.zeros((), jnp.int32),
            needs_reset=jnp.zeros((), bool)))
        return outputs(m, state.data)

    return jax.jit(jax.vmap(one))(
        jnp.asarray(qpos.numpy()), jnp.asarray(qvel.numpy()), act, jdiff,
        jnp.asarray(ctrl.numpy()))


def jax_data(jm, d):
    """The port's Data (B, ...) as a batched JAX Data of model ``jm``:
    every field the two share, the others (the contacts among them) the
    JAX template's, repeated B times."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics.model import make_data

    B = d.qpos.shape[0]
    template = make_data(jm)
    fields = {}
    for f in dataclasses.fields(template):
        mine = getattr(d, f.name, None)
        if isinstance(mine, torch.Tensor):
            fields[f.name] = jnp.asarray(mine.numpy())
        else:
            fields[f.name] = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)),
                getattr(template, f.name))
    return template.replace(**fields)


@pytest.mark.parametrize("domain,task", TASKS)
def test_task_functions_match_jax(domain, task, jax_env=None,
                                  task_kwargs=None, jax_physics=True):
    """``jax_env``: the JAX ``BatchEnv`` to hold the task to (default: the
    JAX suite's); ``task_kwargs`` go to both suites.  Without
    ``jax_physics`` the JAX task reads the port's Data after the port's
    observe (for the models whose JAX physics takes minutes to compile
    here; the golden steps hold that physics to JAX's)."""
    env, qpos, qvel, diff, ctrl = _states(domain, task, task_kwargs)
    n = qpos.shape[0]
    assert all(v.shape[0] == n for v in diff.values())  # one per environment
    (obs, reward, terminate, discount), d = _port(env, qpos, qvel, diff,
                                                  ctrl)
    jobs, jreward, jterminate, jdiscount = _jax(
        domain, task, qpos, qvel, diff, ctrl, jax_env, task_kwargs,
        None if jax_physics else d)
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
    if task.endswith("_sparse"):  # both values of a sparse reward were met
        assert set(np.unique(reward.numpy())) == {0.0, 1.0}
    else:
        assert float(reward.max()) > float(reward.min())
    if domain in MANIPULATION:  # state 0 is one the reward pays for
        assert float(reward[0]) > 0.5
