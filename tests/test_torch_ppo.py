"""The port's PPO learner (``dm_control_torch/rl/ppo.py``) against the JAX
package's (``dm_control_tpu/rl/ppo.py``), in float64 on the CPU.

The JAX parameters and optax state are carried across with
``actor_critic_from_jax``/``adam_state_from_jax``; the JAX draws (its key
splits of the action noise and the epochs' permutations) are handed to the
port through ``make_train_step(draws=)``.  Tolerances: the network 1e-12;
one train step against a stub environment that replays a fixed table
(parameters, Adam moments and count, metrics) 1e-10; one train step of
pendulum:swingup: every step's observation and reward 1e-9, the parameters
after the update 1e-8.  ``train`` resumes from its checkpoint bit for bit.
"""

import collections
import dataclasses
import types
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dm_control_tpu.rl import ppo as jppo
from dm_control_torch import suite as tsuite
from dm_control_torch.rl import ppo
from dm_control_torch.rl.batch_env import rollout
from dm_control_torch.utils.metrics import MetricsWriter, read_metrics


def _np(tree):
    return jax.tree.map(np.array, tree)


def _config(**kwargs):
    """The JAX config and the port's, with the same fields."""
    jcfg = jppo.PPOConfig(**kwargs)
    return jcfg, ppo.PPOConfig(**dataclasses.asdict(jcfg))


def _assert_close(got, want, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= atol, f"{what}: max |d| {err:.3e} > {atol}"


def _assert_params(module, jparams, atol, what="params"):
    want = ppo.actor_critic_from_jax(_np(jparams)).state_dict()
    got = module.state_dict()
    assert list(got) == list(want)
    for name in got:
        _assert_close(got[name], want[name], atol, f"{what} {name}")


class _Replay:
    """The JAX learner's draws, served to the port in order."""

    def __init__(self, normals, perms):
        self.normals, self.perms = list(normals), list(perms)

    def normal(self, shape, dtype):
        x = torch.as_tensor(self.normals.pop(0))
        assert tuple(x.shape) == tuple(shape)
        return x.to(dtype)

    def permutation(self, n):
        p = torch.as_tensor(self.perms.pop(0))
        assert p.shape == (n,)
        return p


def _jax_draws(key, cfg, shape, n):
    """What JAX's ``train_step`` draws from ``TrainState.rng``: the split
    at ``ppo.py:221``, one action key per rollout step (``:168``), one
    permutation key per epoch (``:246-247``)."""
    rng, rkey = jax.random.split(key)
    normals = []
    for _ in range(cfg.steps_per_batch):
        rkey, akey = jax.random.split(rkey)
        normals.append(np.array(jax.random.normal(akey, shape,
                                                    jnp.float64)))
    perms = []
    for _ in range(cfg.update_epochs):
        rng, pkey = jax.random.split(rng)
        perms.append(np.array(jax.random.permutation(pkey, n)))
    return _Replay(normals, perms)


# ---------------------------------------------------------------------------
# (a) the network.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("obs_dim,act_dim,hidden", [
    (5, 2, (7, 4)),  # no w is square: a missed transpose fails
    (6, 1, (64, 64)),
])
def test_network_matches_jax(obs_dim, act_dim, hidden):
    params = jppo.init_actor_critic(jax.random.PRNGKey(obs_dim), obs_dim,
                                    act_dim, hidden, dtype=jnp.float64)
    # biases and log_std away from their initial constants, so that
    # carrying them across is checked too
    rng = np.random.default_rng(obs_dim)
    params = jax.tree.map(
        lambda x: x + 0.1 * rng.normal(size=x.shape), params)
    module = ppo.actor_critic_from_jax(_np(params))
    assert module.log_std.dtype == torch.float64
    obs = rng.normal(size=(7, obs_dim))
    action = rng.normal(size=(7, act_dim))
    jmean, jstd = jppo.policy_distribution(params, jnp.asarray(obs))
    with torch.no_grad():
        mean, std = module.policy_distribution(torch.as_tensor(obs))
        value = module.value(torch.as_tensor(obs))
        logp = ppo.gaussian_logp(mean, std, torch.as_tensor(action))
        sampled, slogp = module.sample_action(torch.as_tensor(obs),
                                              torch.as_tensor(action))
    _assert_close(mean, jmean, 1e-12, "mean")
    _assert_close(std, jstd, 1e-12, "std")
    _assert_close(value, jppo.value(params, jnp.asarray(obs)), 1e-12,
                  "value")
    _assert_close(logp, jppo._gaussian_logp(jmean, jstd, action), 1e-12,
                  "logp")
    jsampled = jmean + jstd * action
    _assert_close(sampled, jsampled, 1e-12, "sampled action")
    _assert_close(slogp, jppo._gaussian_logp(jmean, jstd, jsampled), 1e-12,
                  "sampled logp")


def test_init_actor_critic_draws_as_the_jax_package():
    """w ~ N(0, 1) * sqrt(2 / fan_in) from the generator, b = 0, log_std
    -0.5, in the layout of ``nn.Linear``; the same seed, the same
    module."""
    sizes = (11, 300, 200, 3)
    a = ppo.init_actor_critic(torch.Generator().manual_seed(0), 11, 3,
                              (300, 200), torch.float64)
    b = ppo.init_actor_critic(torch.Generator().manual_seed(0), 11, 3,
                              (300, 200), torch.float64)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    for net, out in ((a.pi, 3), (a.v, 1)):
        dims = sizes[:-1] + (out,)
        for layer, fan_in, fan_out in zip(net, dims[:-1], dims[1:]):
            assert layer.weight.shape == (fan_out, fan_in)
            assert bool((layer.bias == 0).all())
            if fan_in * fan_out >= 3000:
                std = float(layer.weight.detach().std())
                assert abs(std / np.sqrt(2.0 / fan_in) - 1) < 0.05
    assert torch.equal(a.log_std, torch.full((3,), -0.5, dtype=torch.float64))


def test_flatten_obs_matches_jax():
    rng = np.random.default_rng(0)
    obs = collections.OrderedDict(
        a=rng.normal(size=(4,)), b=rng.normal(size=(4, 3)),
        c=rng.normal(size=(4, 2, 2)))
    got = ppo.flatten_obs(collections.OrderedDict(
        (k, torch.as_tensor(v)) for k, v in obs.items()))
    _assert_close(got, jppo.flatten_obs(obs), 0.0, "flat obs")


@pytest.mark.parametrize("max_norm", [0.1, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s) for s in ((3, 4), (4,), (2,))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.zeros(g.shape, dtype=torch.float64, requires_grad=True)
              for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.as_tensor(g).clone()
    norm = ppo.clip_by_global_norm_(params, max_norm)
    assert (float(norm) < max_norm) == (max_norm == 100.0)
    for p, w in zip(params, want):
        _assert_close(p.grad, w, 1e-15, "clipped grad")


# ---------------------------------------------------------------------------
# (b) the learner against a stub environment that replays a table.
# ---------------------------------------------------------------------------

T_STUB, B_STUB, ACT_STUB = 5, 3, 2


class _StubData(NamedTuple):
    qpos: Any


class _StubState(NamedTuple):
    data: _StubData
    t: Any


def _stub_table():
    """Observations before and after each of T steps (a (B,) and a (B, 2)
    entry), rewards and step types: environment 0 ends its episode at step
    1 (LAST) and is reset at step 2 (FIRST), environment 2 likewise at 3
    and 4."""
    rng = np.random.default_rng(2)
    obs = collections.OrderedDict(
        pos=rng.normal(size=(T_STUB + 1, B_STUB)),
        vel=rng.normal(size=(T_STUB + 1, B_STUB, 2)))
    step_type = np.ones((T_STUB, B_STUB), np.int32)
    step_type[1, 0] = step_type[3, 2] = 2
    step_type[2, 0] = step_type[4, 2] = 0
    return obs, rng.uniform(size=(T_STUB, B_STUB)), step_type


class _JaxStub:
    def __init__(self, table):
        self.obs, self.reward, self.step_type = (
            jax.tree.map(jnp.asarray, x) for x in table)

    def step(self, state, action):
        t = state.t
        return state._replace(t=t + 1), types.SimpleNamespace(
            observation=collections.OrderedDict(
                (k, v[t + 1]) for k, v in self.obs.items()),
            reward=self.reward[t], step_type=self.step_type[t])


class _TorchStub:
    def __init__(self, table):
        obs, reward, step_type = table
        self.obs = {k: torch.as_tensor(v) for k, v in obs.items()}
        self.reward = torch.as_tensor(reward)
        self.step_type = torch.as_tensor(step_type)

    def step(self, state, action):
        assert action.dtype == state.data.qpos.dtype
        t = state.t
        return state._replace(t=t + 1), types.SimpleNamespace(
            observation=collections.OrderedDict(
                (k, v[t + 1]) for k, v in self.obs.items()),
            reward=self.reward[t], step_type=self.step_type[t])


def _adam_state(opt, params, seed):
    """optax's chain state for ``params`` with Adam three steps in and
    moments from a seed."""
    rng = np.random.default_rng(seed)
    empty, (adam, tail) = opt.init(params)
    adam = adam._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree.map(lambda x: 0.01 * rng.normal(size=x.shape), adam.mu),
        nu=jax.tree.map(lambda x: 1e-4 * rng.uniform(size=x.shape),
                        adam.nu))
    return empty, (adam, tail)


@pytest.mark.parametrize("max_grad_norm", [1e-3, 1e3], ids=["clip", "noclip"])
@pytest.mark.parametrize("target_kl", [1.0, 1e-6], ids=["nostop", "stop"])
def test_train_step_against_a_stub_matches_jax(target_kl, max_grad_norm,
                                               monkeypatch):
    jcfg, cfg = _config(steps_per_batch=T_STUB, update_epochs=2,
                        num_minibatches=2, pi_lr=0.05, ent_coef=0.01,
                        max_grad_norm=max_grad_norm, target_kl=target_kl)
    table = _stub_table()
    obs0 = jppo.flatten_obs(collections.OrderedDict(
        (k, v[0]) for k, v in table[0].items()))
    params = jppo.init_actor_critic(jax.random.PRNGKey(5), obs0.shape[-1],
                                    ACT_STUB, (6, 4), dtype=jnp.float64)
    key = jax.random.PRNGKey(7)
    jstep, jopt = jppo.make_train_step(_JaxStub(table), jcfg,
                                       obs_dtype=jnp.float64)
    opt_state = _adam_state(jopt, params, 8)
    jstate = jppo.TrainState(
        params=params, opt_state=opt_state,
        env_state=_StubState(_StubData(jnp.zeros((B_STUB, 1))),
                             jnp.asarray(0, jnp.int32)),
        last_obs=obs0, rng=key)
    jnew, jmetrics = jax.jit(jstep)(jstate)

    n = T_STUB * B_STUB  # 15: two minibatches of 7, one slot left out
    draws = _jax_draws(key, cfg, (B_STUB, ACT_STUB), n)
    norms = []
    clip = ppo.clip_by_global_norm_

    def recording_clip(parameters, max_norm):
        norms.append(float(clip(parameters, max_norm)))

    monkeypatch.setattr(ppo, "clip_by_global_norm_", recording_clip)
    step, make_opt = ppo.make_train_step(_TorchStub(table), cfg,
                                         obs_dtype=torch.float64,
                                         draws=lambda generator: draws)
    module = ppo.actor_critic_from_jax(_np(params))
    optimizer = make_opt(module.parameters())
    ppo.adam_state_from_jax(_np(opt_state), module, optimizer)
    state = ppo.TrainState(
        module=module, optimizer=optimizer,
        env_state=_StubState(_StubData(torch.zeros(B_STUB, 1,
                                                   dtype=torch.float64)), 0),
        last_obs=torch.as_tensor(np.array(obs0)),
        generator=torch.Generator())
    new, metrics = step(state)

    assert not draws.normals and not draws.perms  # every draw, in order
    applied = 1 if target_kl < 1e-3 else 4  # the stop: only the first
    adam = jnew.opt_state[1][0]
    assert int(adam.count) == 3 + applied
    assert len(norms) == applied
    assert all((nm >= max_grad_norm) == (max_grad_norm < 1) for nm in norms)
    _assert_params(new.module, jnew.params, 1e-10)
    mu = ppo.actor_critic_from_jax(_np(adam.mu)).state_dict()
    nu = ppo.actor_critic_from_jax(_np(adam.nu)).state_dict()
    for name, p in new.module.named_parameters():
        s = new.optimizer.state[p]
        assert float(s["step"]) == int(adam.count)
        _assert_close(s["exp_avg"], mu[name], 1e-10, f"mu {name}")
        _assert_close(s["exp_avg_sq"], nu[name], 1e-10, f"nu {name}")
    for k in ("pi_loss", "v_loss", "approx_kl", "mean_reward"):
        _assert_close(metrics[k], jmetrics[k], 1e-10, k)
    assert metrics["env_steps"] == int(jmetrics["env_steps"]) == n
    _assert_close(new.last_obs, jnew.last_obs, 0.0, "last obs")
    assert new.env_state.t == T_STUB


# ---------------------------------------------------------------------------
# (c) one train step of a real environment.
# ---------------------------------------------------------------------------


class _JaxRecorder:
    """The JAX env, recording each step's observation and reward."""

    def __init__(self, env):
        self.env, self.rows = env, []

    def _record(self, obs, reward):
        self.rows.append((np.asarray(obs), np.asarray(reward)))

    def step(self, state, action):
        state, ts = self.env.step(state, action)
        jax.debug.callback(self._record, jppo.flatten_obs(ts.observation),
                           ts.reward, ordered=True)
        return state, ts


class _TorchRecorder:
    def __init__(self, env):
        self.env, self.rows = env, []

    def step(self, state, action):
        state, ts = self.env.step(state, action)
        self.rows.append((ppo.flatten_obs(ts.observation), ts.reward))
        return state, ts


def test_pendulum_train_step_matches_jax():
    from dm_control_tpu import suite as jsuite

    batch = 4
    jcfg, cfg = _config(steps_per_batch=8, update_epochs=2,
                        num_minibatches=4)
    jenv = jsuite.load_batch("pendulum", "swingup", dtype=jnp.float64)
    jrec = _JaxRecorder(jenv)
    jstep, jopt = jppo.make_train_step(jrec, jcfg, obs_dtype=jnp.float64)
    # seed 6 starts two of the four pendulums near upright, where the
    # sparse swingup reward pays
    jstate = jppo.init_train_state(jenv, jcfg, jax.random.PRNGKey(6), batch,
                                   jopt, obs_dtype=jnp.float64)
    params = jppo.init_actor_critic(jax.random.PRNGKey(4),
                                    jstate.last_obs.shape[-1],
                                    jenv.model.nu, dtype=jnp.float64)
    jstate = jstate._replace(params=params, opt_state=jopt.init(params))
    jnew, jmetrics = jax.jit(jstep)(jstate)
    jax.effects_barrier()

    env = tsuite.load_batch("pendulum", "swingup", device="cpu",
                            dtype=torch.float64)
    jd, jdiff = jstate.env_state.data, jstate.env_state.model_diff
    env_state = env.from_state(
        *(torch.as_tensor(np.array(getattr(jd, f)))
          for f in ("qpos", "qvel", "qacc_warmstart", "time")),
        generator=torch.Generator().manual_seed(0),
        model_diff={k: torch.as_tensor(np.array(v))
                    for k, v in jdiff.items()} or None)
    rec = _TorchRecorder(env)
    draws = _jax_draws(jstate.rng, cfg, (batch, env.model.nu),
                       cfg.steps_per_batch * batch)
    step, make_opt = ppo.make_train_step(rec, cfg, obs_dtype=torch.float64,
                                         draws=lambda generator: draws)
    module = ppo.actor_critic_from_jax(_np(params))
    new, metrics = step(ppo.TrainState(
        module=module, optimizer=make_opt(module.parameters()),
        env_state=env_state,
        last_obs=torch.as_tensor(np.array(jstate.last_obs)),
        generator=torch.Generator()))

    assert len(rec.rows) == len(jrec.rows) == cfg.steps_per_batch
    for t, ((obs, rew), (jobs, jrew)) in enumerate(zip(rec.rows,
                                                      jrec.rows)):
        _assert_close(obs, jobs, 1e-9, f"obs at step {t}")
        _assert_close(rew, jrew, 1e-9, f"reward at step {t}")
    assert sum(float(r.sum()) for _, r in jrec.rows) > 0
    # T is shorter than an episode: no autoreset, every transition valid
    assert not bool(new.env_state.needs_reset.any())
    _assert_params(new.module, jnew.params, 1e-8)
    for k in ("pi_loss", "v_loss", "approx_kl", "mean_reward"):
        _assert_close(metrics[k], jmetrics[k], 1e-8, k)
    assert float(jnew.opt_state[1][0].count) > 0  # the update ran


# ---------------------------------------------------------------------------
# (d) train(): metrics, checkpoints, bitwise resume.
# ---------------------------------------------------------------------------


def _assert_states_equal(a, b):
    for (name, x), y in zip(a.module.state_dict().items(),
                            b.module.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    for f in ("qpos", "qvel", "qacc_warmstart", "time"):
        assert torch.equal(getattr(a.env_state.data, f),
                           getattr(b.env_state.data, f)), f
    assert torch.equal(a.env_state.step_count, b.env_state.step_count)
    assert torch.equal(a.env_state.needs_reset, b.env_state.needs_reset)
    assert torch.equal(a.last_obs, b.last_obs)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.env_state.rng.get_state(),
                       b.env_state.rng.get_state())


def test_train_logs_metrics_and_checkpoints(tmp_path):
    env = tsuite.load_batch("pendulum", "swingup", device="cpu",
                            dtype=torch.float32)
    cfg = ppo.PPOConfig(steps_per_batch=4, update_epochs=1,
                        num_minibatches=1)
    ck = str(tmp_path / "state.pt")
    state, history = ppo.train(
        env, cfg, batch_size=4, total_steps=32, logdir=str(tmp_path),
        checkpoint_path=ck, checkpoint_every=1)
    assert len(history) == 2  # 4 envs * 4 steps = 16 env steps per iter
    rows = read_metrics(str(tmp_path / "metrics.jsonl"))
    assert len(rows) == 2
    assert "train/fps" in rows[0] and rows[0]["train/fps"] > 0
    assert "train/pi_loss" in rows[0]
    assert rows[1]["train/total_env_steps"] == 32 == rows[1]["step"]

    # the checkpoint restores the exact TrainState
    train_step, opt = ppo.make_train_step(env, cfg)
    template = ppo.init_train_state(env, torch.Generator().manual_seed(9),
                                    4, opt)
    restored = ppo.restore_train_state(ck, template)
    _assert_states_equal(restored, state)

    # continuing from the restored state is continuing from the original,
    # bit for bit; so is train(resume=True) from the checkpoint
    s1, m1 = train_step(state)
    s2, m2 = train_step(restored)
    assert all(torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m2[k]))
               for k in m1)
    _assert_states_equal(s1, s2)
    _, resumed = ppo.train(env, cfg, batch_size=4, total_steps=16,
                           checkpoint_path=ck, resume=True)
    assert resumed[0]["pi_loss"] == float(m1["pi_loss"])
    assert resumed[0]["mean_reward"] == float(m1["mean_reward"])


def test_metrics_writer_writes_the_jax_packages_rows(tmp_path):
    from dm_control_tpu.utils import metrics as jmetrics

    rows = [(16, {"pi_loss": 0.25, "fps": 1e4}, "train"),
            (32, {"x": 1}, None)]
    for mod, sub in ((jmetrics, "jax"), (None, "torch")):
        writer = (mod.MetricsWriter if mod else MetricsWriter)(
            str(tmp_path / sub))
        with writer:
            for step, scalars, group in rows:
                writer.write(step, scalars, group=group)
    got = read_metrics(str(tmp_path / "torch" / "metrics.jsonl"))
    want = jmetrics.read_metrics(str(tmp_path / "jax" / "metrics.jsonl"))
    for row in got + want:
        row.pop("wall_s")
    assert got == want == [{"step": 16, "train/pi_loss": 0.25,
                            "train/fps": 1e4}, {"step": 32, "x": 1.0}]


# ---------------------------------------------------------------------------
# (e) rollout, and the default device.
# ---------------------------------------------------------------------------


def test_rollout_sums_equal_the_step_by_step_sums():
    env = tsuite.load_batch("cartpole", "swingup", device="cpu",
                            dtype=torch.float64)

    def policy(generator, obs):
        assert obs["position"].shape == (3, 3)
        return 2 * torch.rand(3, env.model.nu, generator=generator,
                              dtype=torch.float64) - 1

    state, total = rollout(env, policy, torch.Generator().manual_seed(5), 3,
                           6)
    g = torch.Generator().manual_seed(5)
    s, ts = env.reset(3, g)
    want = torch.zeros(3, dtype=torch.float64)
    for _ in range(6):
        s, ts = env.step(s, policy(g, ts.observation))
        want = want + ts.reward
    assert torch.equal(total, want)
    assert torch.equal(state.data.qpos, s.data.qpos)
    assert float(total.abs().sum()) > 0


def test_load_batch_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        env = tsuite.load_batch("pendulum", "swingup", dtype=torch.float32)
        assert env.model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsuite.load_batch("pendulum", "swingup", dtype=torch.float32)
    env = tsuite.load_batch("pendulum", "swingup", device="cpu",
                            dtype=torch.float32)
    assert env.model.device.type == "cpu"


# ---------------------------------------------------------------------------
# Learning evidence.
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_ppo_improves_cartpole_reward():
    """The port's learner, not just a run: the mean reward of
    cartpole:swingup must improve over a short training run, as
    ``tests/test_training_loop.py`` asks of the JAX package's."""
    env = tsuite.load_batch("cartpole", "swingup", device="cpu",
                            dtype=torch.float32)
    cfg = ppo.PPOConfig(steps_per_batch=64, num_minibatches=4,
                        update_epochs=4)
    train_step, opt = ppo.make_train_step(env, cfg)
    state = ppo.init_train_state(env, torch.Generator().manual_seed(0), 256,
                                 opt)
    first = None
    last = None
    for i in range(30):
        state, metrics = train_step(state)
        r = float(metrics["mean_reward"])
        if i < 3:
            first = r if first is None else max(first, r)
        last = r
    # swingup from hanging: early mean reward is ~0; a learning policy
    # pushes it up by at least 3x (typically much more)
    assert last > max(first * 3, first + 0.02), (first, last)
