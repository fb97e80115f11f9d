"""PPO on PyTorch: actor-critic, rollout, GAE, clipped update with KL stop.

Counterpart of ``dm_control_tpu/rl/ppo.py`` (reference: dm_control's
``scripts/rl/ppo/ppo.py``, GAE-lambda at :65-78, the clipped update with
value and entropy losses and the approximate-KL early stop at :96-253).
JAX's scans become host loops: the rollout is ``steps_per_batch`` calls of
``BatchEnv.step`` under ``torch.no_grad()``, GAE a reverse loop over time,
and the update ``update_epochs`` x ``num_minibatches`` autograd steps of
one ``torch.optim.Adam`` behind optax's global-norm clip.  JAX masks the
KL early stop; here the minibatch whose KL exceeds ``1.5 * target_kl`` and
every later one are simply not applied, so the parameters and the Adam
state (its step count too) stay as they were.  As in JAX, the metrics are
those of the last minibatch of the last epoch, at the parameters reached.

Randomness: the action noise of every rollout step and one permutation
per epoch come from the learner's ``torch.Generator``
(``TrainState.generator``) through ``GeneratorDraws``; the environments'
autoresets draw from their own (``EnvState.rng``).

    env = suite.load_batch("cartpole", "swingup", dtype=torch.float32)
    state, history = ppo.train(env, ppo.PPOConfig(), batch_size=2048,
                               total_steps=10_000_000, logdir="runs/cp")
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from dm_control_torch.rl.control import FIRST, LAST
from dm_control_torch.utils.metrics import MetricsWriter

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
_ENTROPY_CONST = 0.5 * math.log(2 * math.pi * math.e)


# ---------------------------------------------------------------------------
# Actor-critic network.
# ---------------------------------------------------------------------------


def _layers(sizes, dtype, device):
    return nn.ModuleList(
        nn.utils.skip_init(nn.Linear, fan_in, fan_out, dtype=dtype,
                           device=device)
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]))


def _mlp(layers, x):
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


class ActorCritic(nn.Module):
    """Gaussian policy and value function: a tanh MLP ``pi`` (obs ->
    hidden... -> act_dim) for the mean, a separate tanh MLP ``v`` (obs ->
    hidden... -> 1) and a state-independent ``log_std`` (-0.5).  The
    layers are left uninitialised: ``init_actor_critic`` draws them."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.pi = _layers((obs_dim, *hidden, act_dim), dtype, device)
        self.v = _layers((obs_dim, *hidden, 1), dtype, device)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5, dtype=dtype,
                                               device=device))

    def policy_distribution(self, obs):
        """(mean (B, act_dim), std (act_dim,))."""
        return _mlp(self.pi, obs), self.log_std.exp()

    def value(self, obs):
        """(B,)."""
        return _mlp(self.v, obs)[..., 0]

    def sample_action(self, obs, noise):
        """(action, log-probability) for standard normal ``noise`` of the
        action's shape."""
        mean, std = self.policy_distribution(obs)
        action = mean + std * noise
        return action, gaussian_logp(mean, std, action)


def init_actor_critic(generator: torch.Generator, obs_dim: int,
                      act_dim: int, hidden: Sequence[int] = (64, 64),
                      dtype: torch.dtype = torch.float32) -> ActorCritic:
    """An ``ActorCritic`` on the generator's device, initialised as the JAX
    package's ``_init_mlp``: w ~ N(0, 1) * sqrt(2 / fan_in), b = 0."""
    module = ActorCritic(obs_dim, act_dim, hidden, dtype, generator.device)
    with torch.no_grad():
        for layer in (*module.pi, *module.v):
            fan_out, fan_in = layer.weight.shape
            layer.weight.copy_(torch.randn(
                fan_out, fan_in, generator=generator, dtype=dtype,
                device=generator.device) * math.sqrt(2.0 / fan_in))
            layer.bias.zero_()
    return module


def gaussian_logp(mean, std, action):
    """Log-density of ``action`` under N(mean, diag(std^2)), summed over the
    action's entries."""
    z = (action - mean) / std
    return (-0.5 * z * z - std.log() - _HALF_LOG_2PI).sum(-1)


# ---------------------------------------------------------------------------
# Config / containers.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters (defaults follow scripts/rl/ppo/ppo.py:11-22)."""

    steps_per_batch: int = 128  # rollout length per train_step
    gamma: float = 0.99
    lam: float = 0.95
    clip_ratio: float = 0.2
    pi_lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    update_epochs: int = 4
    num_minibatches: int = 4
    max_grad_norm: float = 0.5
    target_kl: float = 0.015


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    # False on autoreset boundaries: the stored action was never executed
    # (the env reset instead), so the transition carries no loss
    valid: torch.Tensor


class TrainState(NamedTuple):
    module: ActorCritic
    optimizer: torch.optim.Optimizer
    env_state: Any
    last_obs: torch.Tensor
    generator: torch.Generator  # the learner's draws


def flatten_obs(obs_dict) -> torch.Tensor:
    """OrderedDict of (B, ...) tensors -> (B, obs_dim), in key order."""
    parts = []
    for v in obs_dict.values():
        if v.ndim == 1:
            v = v[:, None]
        parts.append(v.reshape(v.shape[0], -1))
    return torch.cat(parts, dim=-1)


class GeneratorDraws:
    """The learner's random draws, from one ``torch.Generator``.
    ``make_train_step(draws=)`` takes any factory of an object with these
    two methods (a test hands in another implementation's draws)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, dtype):
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.generator.device)

    def permutation(self, n: int):
        return torch.randperm(n, generator=self.generator,
                              device=self.generator.device)


def clip_by_global_norm_(parameters, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the parameters' gradients, in place:
    left alone where their global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead).  Returns the norm; no host sync."""
    grads = [p.grad for p in parameters]
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


# ---------------------------------------------------------------------------
# The training step.
# ---------------------------------------------------------------------------


def compute_gae(traj: Transition, last_val, gamma: float, lam: float):
    """GAE-lambda advantages and returns, (T, B) each."""
    adv = torch.empty_like(traj.reward)
    gae = torch.zeros_like(last_val)
    next_val = last_val
    for t in reversed(range(traj.reward.shape[0])):
        nonterminal = 1.0 - traj.done[t].to(last_val.dtype)
        delta = traj.reward[t] + gamma * next_val * nonterminal \
            - traj.value[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_val = traj.value[t]
    return adv, adv + traj.value


def _loss(module, config, batch: Transition, adv, ret):
    """(total, pi_loss, v_loss, approx_kl), each term averaged over the
    valid transitions."""
    mean, std = module.policy_distribution(batch.obs)
    logp = gaussian_logp(mean, std, batch.action)
    w = batch.valid.to(adv.dtype)
    wsum = w.sum().clamp(min=1.0)
    log_ratio = logp - batch.logp
    ratio = log_ratio.exp()
    clipped = ratio.clamp(1 - config.clip_ratio, 1 + config.clip_ratio)
    pi_loss = -(torch.minimum(ratio * adv, clipped * adv) * w).sum() / wsum
    v_loss = ((module.value(batch.obs) - ret) ** 2 * w).sum() / wsum
    entropy = (module.log_std + _ENTROPY_CONST).sum()
    # the (exp(lr)-1)-lr estimator of the reference (ppo.py:221-226)
    approx_kl = (((ratio - 1.0) - log_ratio) * w).sum() / wsum
    total = pi_loss + config.vf_coef * v_loss - config.ent_coef * entropy
    return total, pi_loss, v_loss, approx_kl


def make_train_step(env, config: PPOConfig, optimizer=None,
                    obs_dtype: torch.dtype = torch.float32,
                    draws: Callable[[torch.Generator], Any] = GeneratorDraws,
                    mesh=None):
    """Builds ``train_step(state: TrainState) -> (TrainState, metrics)``
    and returns it with the optimizer factory, a callable of the
    parameters, that ``init_train_state`` takes: by default Adam with
    optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) at
    ``config.pi_lr``, applied after the global-norm clip.

    ``train_step`` updates ``state.module`` and ``state.optimizer`` in
    place and returns a state with the new env state and observation.
    ``env`` needs only ``step(env_state, action) -> (env_state, ts)``.

    With ``mesh`` (``dm_control_torch.parallel``) the state holds this
    rank's rows of the env batch (``init_train_state(..., mesh=)``), and
    each rank steps only those (``parallel.shard_env_map``: no collective
    inside the env step).  The learner stays global, as the JAX
    package's: the rollout is gathered from every rank and each rank
    makes the same update.  Every random draw of the learner (action
    noise for the whole batch, the minibatch order) comes from the
    learner's generator, the same on every rank, which keeps its own rows
    of the noise: W ranks of B / W environments compute what one process
    of B computes."""
    optimizer = optimizer or functools.partial(
        torch.optim.Adam, lr=config.pi_lr, betas=(0.9, 0.999), eps=1e-8)
    T = config.steps_per_batch
    if mesh is not None:
        from dm_control_torch import parallel

        env_step = parallel.shard_env_map(mesh, env.step)
        world = mesh.world_size

        def gather(x, dim=0):
            return parallel.all_gather_rows(mesh, x, dim)
    else:
        env_step, world = env.step, 1

        def gather(x, dim=0):
            return x

    def rollout(module, env_state, obs, rand):
        steps = []
        with torch.no_grad():
            for _ in range(T):
                noise = rand.normal((obs.shape[0] * world,
                                     module.log_std.shape[0]),
                                    module.log_std.dtype)
                if mesh is not None:
                    noise = noise[mesh.rows(noise.shape[0])]
                action, logp = module.sample_action(obs, noise)
                val = module.value(obs)
                env_state, ts = env_step(
                    env_state, action.to(env_state.data.qpos.dtype))
                steps.append(Transition(
                    obs=obs, action=action, logp=logp, value=val,
                    reward=ts.reward.to(obs_dtype),
                    done=ts.step_type == LAST,
                    # FIRST: the env auto-reset this step, so the action
                    # never ran and obs is the last episode's terminal one
                    valid=ts.step_type != FIRST))
                obs = flatten_obs(ts.observation).to(obs_dtype)
        return env_state, obs, Transition(*map(torch.stack, zip(*steps)))

    def train_step(state: TrainState):
        module, opt = state.module, state.optimizer
        rand = draws(state.generator)
        env_state, last_obs, traj = rollout(module, state.env_state,
                                            state.last_obs, rand)
        with torch.no_grad():
            # the whole batch's rollout on every rank: (T, B, ...)
            traj = Transition(*(gather(x, 1) for x in traj))
            adv, ret = compute_gae(traj, gather(module.value(last_obs)),
                                   config.gamma, config.lam)
            # (T, B, ...) -> (T*B, ...)
            flat = Transition(*(x.reshape((-1,) + x.shape[2:])
                                for x in traj))
            adv, ret = adv.reshape(-1), ret.reshape(-1)
            # normalised over the valid transitions only (autoreset
            # boundaries carry junk advantages)
            w = flat.valid.to(adv.dtype)
            wsum = w.sum().clamp(min=1.0)
            mean = (adv * w).sum() / wsum
            var = ((adv - mean) ** 2 * w).sum() / wsum
            adv = (adv - mean) / (var.sqrt() + 1e-8)

        n = adv.shape[0]
        mb = n // config.num_minibatches
        stop = False
        for epoch in range(config.update_epochs):
            perm = rand.permutation(n)
            for i in range(config.num_minibatches):
                last = (epoch == config.update_epochs - 1
                        and i == config.num_minibatches - 1)
                if stop and not last:
                    continue
                take = perm[i * mb:(i + 1) * mb]
                batch = Transition(*(x[take] for x in flat))
                with torch.set_grad_enabled(not stop):
                    total, pi_l, v_l, kl = _loss(module, config, batch,
                                                 adv[take], ret[take])
                # KL early stop (reference ppo.py:221-226): the reference
                # breaks BEFORE applying the offending update, so this
                # minibatch's fresh KL gates its own step too
                stop = stop or bool(kl > 1.5 * config.target_kl)
                if stop:
                    continue
                opt.zero_grad()
                total.backward()
                clip_by_global_norm_(module.parameters(),
                                     config.max_grad_norm)
                opt.step()

        metrics = {
            "pi_loss": pi_l.detach(), "v_loss": v_l.detach(),
            "approx_kl": kl.detach(), "mean_reward": traj.reward.mean(),
            "env_steps": T * traj.reward.shape[1],
        }
        return TrainState(module=module, optimizer=opt, env_state=env_state,
                          last_obs=last_obs,
                          generator=state.generator), metrics

    return train_step, optimizer


def init_train_state(env, generator: torch.Generator, batch_size: int,
                     optimizer, obs_dtype: torch.dtype = torch.float32,
                     mesh=None) -> TrainState:
    """Resets ``batch_size`` environments (their episodes, and later
    autoresets, draw from ``generator``) and builds the 64-64 module in
    ``obs_dtype`` on the env's device, and its optimizer.  The learner's
    generator is seeded from one draw of ``generator``.  (The JAX package
    keeps float32 parameters whatever ``obs_dtype`` is.)

    With ``mesh`` every rank, given the same ``generator``, draws the
    same ``batch_size`` episodes and keeps its rows of them
    (``parallel.shard_batch``); a rank's later autoresets draw from a
    generator of its own, seeded from one more draw and its rank (so
    they are not those of one process of ``batch_size``)."""
    device = env.model.device
    seed = int(torch.randint(2 ** 62, (), generator=generator,
                             device=generator.device))
    learner = torch.Generator(device=device).manual_seed(seed)
    env_state, ts = env.reset(batch_size, generator)
    if mesh is not None:
        from dm_control_torch import parallel

        env_seed = int(torch.randint(2 ** 62, (), generator=generator,
                                     device=generator.device))
        env_state, ts = parallel.shard_batch(mesh, (env_state, ts),
                                             batch=batch_size)
        env_state = env_state.replace(rng=torch.Generator(
            device=device).manual_seed(env_seed + mesh.rank))
    obs = flatten_obs(ts.observation).to(obs_dtype)
    module = init_actor_critic(learner, obs.shape[-1], env.model.nu,
                               dtype=obs_dtype)
    return TrainState(module=module, optimizer=optimizer(module.parameters()),
                      env_state=env_state, last_obs=obs, generator=learner)


# ---------------------------------------------------------------------------
# Checkpointing and the training loop with scalar logging (reference
# scripts/rl/ppo/ppo.py:119-160 TensorBoard scalars; trainer.py:56-60
# torch.save checkpoints).
# ---------------------------------------------------------------------------


def save_train_state(path, state: TrainState) -> None:
    """Writes ``state`` with ``torch.save`` (``path``: a file name or a
    binary file): the module's and the optimizer's state dicts, the
    EnvState's tensors and model diff, ``last_obs`` and the states of both
    generators, so that a restored run continues bitwise."""
    es = state.env_state
    data = {f.name: getattr(es.data, f.name)
            for f in dataclasses.fields(es.data)
            if getattr(es.data, f.name) is not None}
    torch.save({
        "module": state.module.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "env": {"data": data, "model_diff": es.model_diff,
                "step_count": es.step_count, "needs_reset": es.needs_reset,
                "rng": es.rng.get_state()},
        "last_obs": state.last_obs,
        "generator": state.generator.get_state(),
    }, path)


def _generator(like: torch.Generator, saved) -> torch.Generator:
    g = torch.Generator(device=like.device)
    g.set_state(saved)
    return g


def restore_train_state(path, template: TrainState) -> TrainState:
    """The state saved by ``save_train_state`` at ``path``, on the
    template's device.  ``template`` (a fresh ``init_train_state`` of the
    same env, batch and network) gives the structure: its module and
    optimizer are loaded in place; the generators are new."""
    ck = torch.load(path, weights_only=True)
    device = template.last_obs.device
    template.module.load_state_dict(ck["module"])
    template.optimizer.load_state_dict(ck["optimizer"])
    es, saved = template.env_state, ck["env"]
    env_state = es.replace(
        data=es.data.replace(**{k: v.to(device)
                                for k, v in saved["data"].items()}),
        model_diff={k: v.to(device) for k, v in saved["model_diff"].items()},
        rng=_generator(es.rng, saved["rng"]),
        step_count=saved["step_count"].to(device),
        needs_reset=saved["needs_reset"].to(device))
    return TrainState(module=template.module, optimizer=template.optimizer,
                      env_state=env_state,
                      last_obs=ck["last_obs"].to(device),
                      generator=_generator(template.generator,
                                           ck["generator"]))


def train(env, config: PPOConfig, *, batch_size: int, total_steps: int,
          generator: Optional[torch.Generator] = None,
          logdir: Optional[str] = None,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 10, log_every: int = 1,
          resume: bool = False):
    """Runs PPO on the env's device until ``total_steps`` env steps,
    logging the scalar metrics (env-steps/s as ``fps`` too) under group
    ``train`` and checkpointing every ``checkpoint_every`` iterations and
    at the end.  ``generator`` (default: seed 0 on the env's device) draws
    the episodes and seeds the learner.

    Returns (final TrainState, list of metric dicts)."""
    device = env.model.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    train_step, optimizer = make_train_step(env, config)
    state = init_train_state(env, generator, batch_size, optimizer)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state = restore_train_state(checkpoint_path, state)

    writer = MetricsWriter(logdir) if logdir else None
    history = []
    env_steps = 0
    it = 0
    try:
        while env_steps < total_steps:
            t0 = time.perf_counter()
            state, metrics = train_step(state)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            it += 1
            env_steps += metrics["env_steps"]
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["fps"] = metrics["env_steps"] / dt
            scalars["total_env_steps"] = env_steps
            history.append(scalars)
            if writer and it % log_every == 0:
                writer.write(env_steps, scalars, group="train")
            if checkpoint_path and it % checkpoint_every == 0:
                save_train_state(checkpoint_path, state)
        if checkpoint_path:
            save_train_state(checkpoint_path, state)
    finally:
        if writer:
            writer.close()
    return state, history


# ---------------------------------------------------------------------------
# Carrying the JAX package's learner state across (numpy only).
# ---------------------------------------------------------------------------


def _from_jax_tree(tree):
    """The JAX package's parameter pytree (``{"pi": [{"w", "b"}, ...],
    "v": [...], "log_std"}``, numpy leaves) as tensors by the port's
    parameter names, in the port's layout: JAX's w (fan_in, fan_out) is
    ``nn.Linear``'s weight (fan_out, fan_in) transposed."""
    out = {"log_std": torch.as_tensor(np.array(tree["log_std"]))}
    for net in ("pi", "v"):
        for i, layer in enumerate(tree[net]):
            out[f"{net}.{i}.weight"] = torch.as_tensor(
                np.array(np.asarray(layer["w"]).T))
            out[f"{net}.{i}.bias"] = torch.as_tensor(np.array(layer["b"]))
    return out


def actor_critic_from_jax(params) -> ActorCritic:
    """A CPU ``ActorCritic`` (in the leaves' own dtype) holding the JAX
    package's actor-critic parameters (``init_actor_critic``'s pytree with
    numpy leaves)."""
    tensors = _from_jax_tree(params)
    shapes = [np.shape(layer["w"]) for layer in params["pi"]]
    module = ActorCritic(shapes[0][0], shapes[-1][1],
                         tuple(s[1] for s in shapes[:-1]),
                         dtype=tensors["log_std"].dtype, device="cpu")
    module.load_state_dict(tensors)
    return module


def _adam_state(tree):
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    if isinstance(tree, (tuple, list)):
        for x in tree:
            found = _adam_state(x)
            if found is not None:
                return found
    return None


def adam_state_from_jax(opt_state, module: ActorCritic,
                        optimizer: torch.optim.Optimizer) -> None:
    """Loads optax's Adam state, ``ScaleByAdamState(count, mu, nu)`` found
    in the chain's state (``(EmptyState, (ScaleByAdamState, EmptyState))``
    for the JAX ``make_train_step``'s default) with numpy leaves, into
    ``optimizer``, a ``torch.optim.Adam`` over ``module``'s parameters:
    the step count and both moments."""
    state = _adam_state(opt_state)
    if state is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    mu, nu = _from_jax_tree(state.mu), _from_jax_tree(state.nu)
    for name, p in module.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(float(state.count)),
                              "exp_avg": mu[name].to(p),
                              "exp_avg_sq": nu[name].to(p)}
