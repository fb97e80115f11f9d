"""The port's training scripts against the JAX package's, on the CPU.

- Every model of ``scripts/model.py`` against its flax module, the flax
  parameters carried over by ``from_flax_params``: actions, log-probs,
  values and losses within 1e-6 of their scale in float32 and 1e-12 in
  float64, of the flax module's outputs in float64 on the same
  parameters and inputs (flax's own float32 outputs lie within the same
  bound).
- ``PPOTrainer``'s minibatch update (the loss, the global-norm clip and
  Adam) from carried-over parameters on a fixed batch: the parameters
  after two updates within 1e-10 of the JAX trainer's, in float64, with
  the clip engaged and not; ``PPOBuffer``'s GAE equal to the JAX buffer's.
- ``DummyVecEnv`` against the JAX one on a scripted environment
  (autoreset and ``terminal_observation``), and on pendulum; ``TorchVecEnv``
  flattening observations in ``JaxVecEnv``'s key order, with its
  autoreset; ``SubprocVecEnv`` started by ``spawn`` on two environments.
- One ``ppo_tracking`` epoch on the CPU.

JAX's trainer and models run as the JAX package's tests run them: flax
modules applied and one ``jax.jit`` update, on the CPU.
"""

import functools
import types

import numpy as np
import pytest
import torch

from dm_control_torch.scripts import model as tmodel
from dm_control_torch.scripts import ppo as tppo
from dm_control_torch.scripts import vec_env as tvec

TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
NP = {torch.float32: np.float32, torch.float64: np.float64}
GPT_SIZES = dict(obs_size=5, action_size=3, block_size=4, n_layer=2,
                 n_head=2, n_embd=16)


def _cast(tree, dtype):
    import jax

    return jax.tree_util.tree_map(lambda x: np.asarray(x, NP[dtype]), tree)


def _close(ours, theirs, dtype, what):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    theirs = np.asarray(theirs)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=TOL[dtype] * scale, err_msg=what)


def _models():
    """name -> (flax module, torch module, inputs, runs): each run is the
    keyword arguments of one call and the names of its outputs."""
    from dm_control_tpu.scripts import model as jmodel

    rng = np.random.RandomState(0)
    obs = rng.randn(6, 5)
    act = 0.5 * rng.randn(6, 3)
    seq, targets = rng.randn(2, 4, 5), np.tanh(rng.randn(2, 4, 3))
    gpt = jmodel.GPTConfig(**GPT_SIZES)
    ff = jmodel.FFConfig(obs_size=5, action_size=3, hidden_size=32)
    return {
        "actor_critic": (
            jmodel.ActorCritic(action_size=3), tmodel.ActorCritic(5, 3),
            obs, [({"deterministic": True}, ("mu", "std", "a", "v", "logp")),
                  ({"act": act}, ("mu", "std", "a", "v", "logp"))]),
        "squashed_head": (
            jmodel.SquashedGaussianHead(3), tmodel.SquashedGaussianHead(5, 3),
            obs, [({"deterministic": True}, ("a", "logp")),
                  ({"act": act}, ("a", "logp"))]),
        "ffnet": (jmodel.FFNet(ff),
                  tmodel.FFNet(tmodel.FFConfig(**vars(ff))), obs,
                  [({"targets": act}, ("out", "loss"))]),
        "gpt": (jmodel.GPT(gpt), tmodel.GPT(tmodel.GPTConfig(**vars(gpt))),
                seq, [({}, ("actions",)),
                      ({"targets": targets}, ("actions", "loss"))]),
    }


def _flat_outputs(out):
    flat = []
    for x in out:
        if isinstance(x, tuple):
            flat.extend(x)
        elif x is not None:
            flat.append(x)
    return flat


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["actor_critic", "squashed_head", "ffnet",
                                  "gpt"])
def test_model_matches_flax(name, dtype):
    import jax
    import jax.numpy as jnp

    flax_module, module, x, runs = _models()[name]
    x = np.asarray(x, NP[dtype])
    params = flax_module.init(jax.random.PRNGKey(1),
                              jnp.asarray(x, jnp.float32))["params"]
    params = _cast(params, dtype)
    module = module.to(dtype)
    state = type(module).from_flax_params(params)
    assert set(state) == set(module.state_dict()), name
    module.load_state_dict(state)

    def flax_outputs(kwargs, as_type):
        # the module applied in ``as_type`` to the values of ``dtype``
        return _flat_outputs(flax_module.apply(
            {"params": _cast(params, as_type)}, jnp.asarray(x, NP[as_type]),
            **{k: (jnp.asarray(np.asarray(v, NP[dtype]), NP[as_type])
                   if isinstance(v, np.ndarray) else v)
               for k, v in kwargs.items()}))

    for kwargs, names in runs:
        # the reference is the flax module in float64 on the same values;
        # in float32 flax's own outputs lie within the bound too
        theirs = flax_outputs(kwargs, torch.float64)
        ours = _flat_outputs(module(
            torch.as_tensor(x),
            **{k: (torch.as_tensor(v, dtype=dtype)
                   if isinstance(v, np.ndarray) else v)
               for k, v in kwargs.items()}))
        assert len(theirs) == len(ours) == len(names)
        for what, a, b in zip(names, ours, theirs):
            assert a.dtype == dtype, what
            _close(a, b, dtype, f"{name} {kwargs} {what}")
        if dtype == torch.float32:
            for what, a, b in zip(names, flax_outputs(kwargs, dtype),
                                  theirs):
                _close(np.asarray(a), b, dtype, f"flax {name} {what}")
    assert tmodel.count_params(module) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(params))


def test_gpt_config_json_and_dropout(tmp_path):
    """Configs round-trip through JSON; dropout draws from the generator
    (the same generator state, the same mask), and is off when
    deterministic."""
    cfg = tmodel.GPTConfig(**GPT_SIZES)
    cfg.to_json(str(tmp_path / "c.json"))
    assert tmodel.GPTConfig.from_json(str(tmp_path / "c.json")) == cfg
    assert tmodel.GPT1Config(5, 3, 4).n_embd == 768
    model = tmodel.init_model(tmodel.GPT(cfg),
                              torch.Generator().manual_seed(0))
    obs = torch.randn(2, 4, 5, generator=torch.Generator().manual_seed(1))
    runs = [model(obs, deterministic=False,
                  generator=torch.Generator().manual_seed(s))[0]
            for s in (2, 2, 3)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    torch.testing.assert_close(model(obs)[0], model(obs)[0], rtol=0, atol=0)


def test_init_model_follows_flax():
    """flax's initialisers: LeCun-normal kernels truncated at two
    deviations (their deviation about 1 / sqrt(fan_in)), zero biases, the
    log-std -0.5; the draws repeat under the same generator."""
    model = tmodel.init_model(tmodel.ActorCritic(400, 6, hidden_size=300),
                              torch.Generator().manual_seed(0))
    w = model.pi_fc1.weight.detach()
    assert abs(float(w.std()) - 400 ** -0.5) < 0.02 * 400 ** -0.5
    assert float(w.abs().max()) <= 2 * 400 ** -0.5 / .87962566103423978
    assert float(model.v_fc1.bias.detach().abs().max()) == 0.0
    assert model.policy_head.log_std.tolist() == [-0.5] * 6
    again = tmodel.init_model(tmodel.ActorCritic(400, 6, hidden_size=300),
                              torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.pi_fc1.weight, w, rtol=0, atol=0)


# -- PPO ----------------------------------------------------------------------


def _batch(rng, n, obs_dim, act_dim):
    return dict(obs=rng.randn(n, obs_dim), act=0.5 * rng.randn(n, act_dim),
                logp=rng.randn(n) - 3.0, adv=rng.randn(n),
                ret=rng.randn(n), val=rng.randn(n))


@pytest.mark.parametrize("grad_norm_clip", [0.5, 1e6],
                         ids=["clipped", "unclipped"])
def test_ppo_update_matches_jax(grad_norm_clip):
    """Two minibatch updates from the same parameters on fixed batches:
    the losses and (pg, v, entropy, approx_kl) within 1e-12, the
    parameters after Adam within 1e-10 (float64)."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.scripts import model as jmodel
    from dm_control_tpu.scripts import ppo as jppo

    config = dict(lr=3e-3, grad_norm_clip=grad_norm_clip, ent_coef=0.01,
                  seed=0)
    jtrainer = jppo.PPOTrainer(jmodel.ActorCritic(action_size=3), None,
                               None, jppo.PPOTrainerConfig(**config))
    rng = np.random.RandomState(4)
    jtrainer.init_params(rng.randn(2, 7))
    params = _cast(jtrainer.params, torch.float64)
    opt_state = jtrainer._opt.init(params)
    policy = tmodel.ActorCritic(7, 3).double()
    policy.load_state_dict(tmodel.ActorCritic.from_flax_params(params))
    trainer = tppo.PPOTrainer(policy, None, None,
                              tppo.PPOTrainerConfig(**config), device="cpu")
    trainer.make_optimizer()
    for _ in range(2):
        batch = _batch(rng, 32, 7, 3)
        params, opt_state, jloss, jaux = jtrainer._update_minibatch(
            params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, aux = trainer.update_minibatch(batch)
        for a, b in zip((loss,) + aux, (jloss,) + tuple(jaux)):
            _close(a, b, torch.float64, "loss")
    ours = policy.state_dict()
    for key, value in tmodel.ActorCritic.from_flax_params(params).items():
        np.testing.assert_allclose(ours[key].numpy(), value.numpy(), rtol=0,
                                   atol=1e-10, err_msg=key)
    moved = tmodel.ActorCritic.from_flax_params(_cast(
        jtrainer.params, torch.float64))
    assert max(float((ours[k] - moved[k]).abs().max()) for k in ours) > 1e-3


def test_ppo_buffer_gae_matches_jax():
    from dm_control_tpu.scripts import ppo as jppo

    rng = np.random.RandomState(2)
    buffers = [lib.PPOBuffer(4, 2, 3, 6, 0.99, 0.95) for lib in (tppo, jppo)]
    rows = [(rng.randn(3, 4), rng.randn(3, 2), rng.randn(3),
             (rng.rand(3) < 0.3).astype(np.float32), rng.randn(3),
             rng.randn(3)) for _ in range(6)]
    last = rng.randn(3).astype(np.float32)
    for buf in buffers:
        for row in rows:
            buf.store(*row)
        buf.compute_returns_and_advantage(last)
    ours, theirs = buffers[0].get(), buffers[1].get()
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert buffers[0].dones.sum() > 0 and buffers[0].ptr == 0


# -- vectorised environments --------------------------------------------------


class _Scripted:
    """A dm_env environment replaying a table: observation {"b": 2-vector,
    "a": scalar}, an episode of ``length`` steps."""

    def __init__(self, length, offset):
        self.length, self.offset, self.t, self.episodes = length, offset, 0, 0

    def _ts(self, step_type, reward):
        obs = {"b": np.array([self.t, self.episodes]) + self.offset,
               "a": np.float64(-self.t)}
        return types.SimpleNamespace(
            observation=obs, reward=reward,
            last=lambda: step_type == 2)

    def reset(self):
        self.t, self.episodes = 0, self.episodes + 1
        return self._ts(0, None)

    def step(self, action):
        self.t += 1
        return self._ts(2 if self.t == self.length else 1,
                        float(np.sum(action)) + self.t)


def test_dummy_vec_env_matches_jax():
    """The scripted environments through both DummyVecEnvs: the same
    observations (sorted keys: "a" before "b"), rewards, dones and
    terminal observations; an ended episode resets in the same step."""
    from dm_control_tpu.scripts import vec_env as jvec

    venvs = [lib.DummyVecEnv([functools.partial(_Scripted, 2 + i, 10 * i)
                              for i in range(2)]) for lib in (tvec, jvec)]
    outs = [[v.reset()] for v in venvs]
    for t in range(4):
        actions = np.full((2, 1), t, np.float32)
        for v, out in zip(venvs, outs):
            out.append(v.step(actions))
    ours, theirs = outs
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[0].tolist() == [[0, 0, 1], [0, 10, 11]]
    for (o, r, d, i), (jo, jr, jd, ji) in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(r, jr)
        assert r.dtype == np.float32
        np.testing.assert_array_equal(d, jd)
        assert len(i) == len(ji) == 2
        for a, b in zip(i, ji):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    assert ours[2][2].tolist() == [True, False]
    np.testing.assert_array_equal(ours[2][3][0]["terminal_observation"],
                                  [-2, 2, 1])
    assert ours[2][0][0].tolist() == [0, 0, 2]  # the next episode's reset
    assert venvs[0].get_attr("length") == [2, 3]


def _pendulum(seed, time_limit=0.06):
    from dm_control_torch import suite

    return suite.load("pendulum", "swingup",
                      task_kwargs={"random": seed, "time_limit": time_limit},
                      device="cpu")


def test_vec_envs_over_pendulum():
    """pendulum:swingup, 3 control steps an episode, through
    ``DummyVecEnv`` and ``SubprocVecEnv`` (two workers started by spawn):
    the same observations, rewards, dones and terminal observations."""
    fns = [functools.partial(_pendulum, s) for s in (0, 1)]
    dummy = tvec.DummyVecEnv(fns)
    sub = tvec.SubprocVecEnv(fns)
    try:
        assert sub.processes[0]._popen.method == "spawn"
        outs = [[v.reset()] for v in (dummy, sub)]
        for t in range(4):
            actions = np.full((2, 1), 0.3 * t - 0.5)
            for v, out in zip((dummy, sub), outs):
                out.append(v.step(actions))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert outs[0][0].shape == (2, 3)
        for a, b in zip(outs[0][1:], outs[1][1:]):
            for x, y in zip(a[:3], b[:3]):
                np.testing.assert_array_equal(x, y)
            for i, j in zip(a[3], b[3]):
                assert i.keys() == j.keys()
        assert outs[0][3][2].tolist() == [True, True]
        assert all("terminal_observation" in i for i in outs[1][3][3])
        assert sub.env_method("action_spec")[0].shape == (1,)
    finally:
        sub.close()
    assert all(not p.is_alive() for p in sub.processes)


def test_torch_vec_env_flattens_like_jax_and_autoresets():
    """``TorchVecEnv`` over pendulum:swingup at B = 4: observations
    flattened in ``JaxVecEnv``'s sorted-key order; an episode of 3 control
    steps ends (dones) and the environments start anew at the next step;
    seeded again, it draws the same episodes."""
    from dm_control_tpu.scripts.vec_env import JaxVecEnv
    from dm_control_torch import suite

    env = suite.load_batch("pendulum", "swingup", device="cpu",
                           dtype=torch.float64)
    venv = tvec.TorchVecEnv(env.model, env.task, 4, seed=3,
                            time_limit=0.06, control_timestep=0.02)
    obs = obs0 = venv.reset()
    assert obs.shape == (4, 3) and obs.dtype == np.float32
    ts_obs = {k: v for k, v in env.reset(
        4, torch.Generator().manual_seed(3))[1].observation.items()}
    np.testing.assert_array_equal(
        obs, JaxVecEnv._flat({k: v.numpy() for k, v in ts_obs.items()}))
    np.testing.assert_array_equal(obs, tvec.TorchVecEnv._flat(ts_obs))
    dones = []
    for _ in range(4):
        obs, rew, done, infos = venv.step(np.zeros((4, 1)))
        dones.append(done.tolist())
        assert rew.shape == (4,) and np.isfinite(obs).all()
        assert len(infos) == 4
    assert dones == [[False] * 4, [False] * 4, [True] * 4, [False] * 4]
    assert venv._state.step_count.tolist() == [0] * 4
    assert venv.seed(3) == [3] * 4
    np.testing.assert_array_equal(venv.reset(), obs0)


def test_ppo_tracking_epoch_on_the_cpu():
    """One epoch of ``ppo_tracking`` (two CMU humanoid tracking
    environments, 8 env steps) on the CPU: finite losses and KL, the
    policy's parameters moved, the epoch's seconds split."""
    from dm_control_torch.scripts import ppo_tracking

    args = ppo_tracking.parse_args([
        "--n_envs=2", "--steps_per_epoch=8", "--max_epochs=1",
        "--device=cpu", "--seed=1"])
    assert args.observables == ["walker/joints_pos", "walker/joints_vel"]
    trainer = ppo_tracking.make_trainer(args)
    assert trainer.env.envs[0].physics.model.dtype == torch.float32
    trainer.config.gradient_steps_per_update = 4
    obs = trainer.env.reset()
    trainer.init_params(obs)
    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    (stats,) = trainer.train()
    for k in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
        assert np.isfinite(stats[k]), k
    assert stats["env_steps"] == 8 and 1 <= stats["grad_steps"] <= 4
    assert stats["env_s"] + stats["policy_s"] + stats["update_s"] <= (
        stats["time"] + 1e-6)
    after = trainer.policy.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    wrapped = ppo_tracking.EnvWrap(trainer.eval_env, args.observables)
    assert wrapped.reset().shape == (112,)
