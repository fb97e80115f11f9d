"""PPO over a VecEnv of host environments (counterpart of
``dm_control_tpu/scripts/ppo.py``; reference: dm_control/scripts/rl/ppo/
ppo.py).

``PPOBuffer`` stores a rollout of steps x envs in numpy and computes
GAE-lambda; ``PPOTrainer`` alternates a rollout through the VecEnv with
minibatch updates of the clipped surrogate, the value loss and the
entropy bonus, stopping early on the approximate KL.  The policy (an
``ActorCritic``, ``scripts/model.py``) and its update run on the
trainer's device, the card unless the caller asks for another
(``device="cpu"``).  The optimiser is Adam after a clip of the gradients'
global norm (optax's ``chain(clip_by_global_norm, adam)``).  Action noise
comes from the trainer's ``torch.Generator``; each update's minibatch
indices from a ``np.random.RandomState`` seeded from it.

The batched PPO over a ``BatchEnv``, whose rollout, GAE and updates stay
on the device, is ``dm_control_torch.rl.ppo``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dm_control_torch.rl.ppo import clip_by_global_norm_
from dm_control_torch.scripts.model import init_model
from dm_control_torch.scripts.vec_env import flatten_obs_dict
from dm_control_torch.suite import check_device


class PPOBuffer:
    """Rollout storage of steps x envs, with GAE-lambda."""

    def __init__(self, obs_dim, act_dim, n_envs, buffer_size, gamma, lam):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.n_envs, self.buffer_size = n_envs, buffer_size
        self.gamma, self.gae_lambda = gamma, lam
        self.reset()

    def reset(self):
        B, E = self.buffer_size, self.n_envs
        self.observations = np.zeros((B, E, self.obs_dim), np.float32)
        self.actions = np.zeros((B, E, self.act_dim), np.float32)
        self.rewards = np.zeros((B, E), np.float32)
        self.dones = np.zeros((B, E), np.float32)
        self.values = np.zeros((B, E), np.float32)
        self.log_probs = np.zeros((B, E), np.float32)
        self.advantages = np.zeros((B, E), np.float32)
        self.returns = np.zeros((B, E), np.float32)
        self.ptr = 0

    def store(self, obs, act, rew, done, val, logp):
        i = self.ptr
        self.observations[i] = obs
        self.actions[i] = act
        self.rewards[i] = rew
        self.dones[i] = done
        self.values[i] = val
        self.log_probs[i] = logp
        self.ptr += 1

    def compute_returns_and_advantage(self, last_values):
        """GAE-lambda advantages, and returns = advantages + values."""
        last_gae = 0.0
        for step in reversed(range(self.buffer_size)):
            if step == self.buffer_size - 1:
                next_values = last_values
            else:
                next_values = self.values[step + 1]
            nonterminal = 1.0 - self.dones[step]
            delta = (self.rewards[step]
                     + self.gamma * next_values * nonterminal
                     - self.values[step])
            last_gae = (delta + self.gamma * self.gae_lambda
                        * nonterminal * last_gae)
            self.advantages[step] = last_gae
        self.returns = self.advantages + self.values

    def get(self):
        self.ptr = 0
        flat = lambda x: x.reshape(-1, *x.shape[2:])  # noqa: E731
        return dict(obs=flat(self.observations), act=flat(self.actions),
                    ret=flat(self.returns), adv=flat(self.advantages),
                    val=flat(self.values), logp=flat(self.log_probs))


class PPOTrainerConfig:
    """The trainer's settings; the defaults are the reference's flags."""

    def __init__(self, **kw):
        self.max_epochs = kw.get("max_epochs", 100)
        self.steps_per_epoch = kw.get("steps_per_epoch", 2048)
        self.gradient_steps_per_update = kw.get(
            "gradient_steps_per_update", 64)
        self.lr = kw.get("lr", 3e-4)
        self.clip_ratio = kw.get("clip_ratio", 0.2)
        self.ent_coef = kw.get("ent_coef", 0.0)
        self.vf_coef = kw.get("vf_coef", 0.5)
        self.grad_norm_clip = kw.get("grad_norm_clip", 0.5)
        self.gamma = kw.get("gamma", 0.99)
        self.lam = kw.get("lam", 0.97)
        self.target_kl = kw.get("target_kl", 0.01)
        self.eval_episodes = kw.get("eval_episodes", 5)
        self.minibatch_size = kw.get("minibatch_size", 256)
        self.seed = kw.get("seed", 0)


class PPOTrainer:
    """The rollout -> update loop of an ``ActorCritic`` ``policy`` over
    ``vec_env``; ``eval_env`` (a dm_env environment, or None) serves
    ``evaluate``.  The policy moves to ``device``; its dtype is kept."""

    def __init__(self, policy, vec_env, eval_env, config, *,
                 device="cuda"):
        check_device("scripts.ppo.PPOTrainer", device)
        self.device = torch.device(device)
        self.policy = policy.to(self.device)
        self.dtype = next(policy.parameters()).dtype
        self.env = vec_env
        self.eval_env = eval_env
        self.config = config
        self.generator = torch.Generator(self.device).manual_seed(
            config.seed)
        self.opt = None
        #: the present epoch's seconds in the environments and the policy
        self.timing = dict(env_s=0.0, policy_s=0.0)

    # -- the policy on the device -------------------------------------------

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    @torch.no_grad()
    def _act(self, obs, deterministic=False):
        """(action, value, log-prob) of host observations, as numpy."""
        _, a, v, logp = self.policy(self._tensor(obs),
                                    deterministic=deterministic,
                                    generator=self.generator)
        return (a.cpu().numpy(), v.cpu().numpy(), logp.cpu().numpy())

    def init_params(self, example_obs=None):
        """Initialises the policy as flax initialises the JAX module, from
        the trainer's generator, and makes the optimiser."""
        del example_obs  # the policy's sizes are its own
        init_model(self.policy, self.generator)
        self.make_optimizer()

    def make_optimizer(self):
        """Adam over the policy's present parameters (after
        ``init_params``, or after a ``load_state_dict``)."""
        self.opt = torch.optim.Adam(self.policy.parameters(),
                                    lr=self.config.lr)

    def update_minibatch(self, batch):
        """One gradient step on a minibatch (dict of obs, act, logp, adv,
        ret arrays): the loss and its gradients, the global-norm clip and
        Adam.  Returns the loss and (pg_loss, v_loss, entropy, approx_kl)
        as tensors."""
        cfg = self.config
        b = {k: self._tensor(v) for k, v in batch.items()}
        (mu, std), _, v, logp = self.policy(b["obs"], act=b["act"],
                                            deterministic=True)
        ratio = torch.exp(logp - b["logp"])
        adv = b["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clipped = torch.clamp(ratio, 1 - cfg.clip_ratio, 1 + cfg.clip_ratio)
        pg_loss = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
        v_loss = torch.mean((v - b["ret"]) ** 2)
        ent = torch.mean(torch.sum(
            torch.log(std) + 0.5 * (1 + np.log(2 * np.pi)), dim=-1))
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        approx_kl = torch.mean(b["logp"] - logp)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        clip_by_global_norm_(list(self.policy.parameters()),
                             cfg.grad_norm_clip)
        self.opt.step()
        return loss.detach(), tuple(x.detach() for x in
                                    (pg_loss, v_loss, ent, approx_kl))

    # -- the loop -------------------------------------------------------------

    def collect_rollout(self, obs, buffer):
        """Fills ``buffer`` from ``obs`` on; returns the last observation.
        Adds the seconds in the environments and in the policy (its
        copies to and from the host included) to ``self.timing``."""
        for _ in range(buffer.buffer_size):
            t0 = time.perf_counter()
            a, v, logp = self._act(obs)
            t1 = time.perf_counter()
            next_obs, rew, done, infos = self.env.step(a)
            self.timing["env_s"] += time.perf_counter() - t1
            self.timing["policy_s"] += t1 - t0
            buffer.store(obs, a, rew, done.astype(np.float32), v, logp)
            obs = next_obs
        t0 = time.perf_counter()
        _, last_v, _ = self._act(obs)
        self.timing["policy_s"] += time.perf_counter() - t0
        buffer.compute_returns_and_advantage(last_v)
        return obs

    def update(self, buffer):
        """Minibatch updates, stopped early where |approx_kl| passes 1.5
        x target_kl."""
        data = buffer.get()
        n = data["obs"].shape[0]
        mb = min(self.config.minibatch_size, n)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), device=self.device,
                                 generator=self.generator))
        rng = np.random.RandomState(seed)
        stats = {}
        for it in range(self.config.gradient_steps_per_update):
            idx = rng.randint(0, n, mb)
            loss, aux = self.update_minibatch(
                {k: v[idx] for k, v in data.items()})
            pg, vl, ent, kl = [float(x) for x in aux]
            stats = dict(loss=float(loss), pg_loss=pg, v_loss=vl,
                         entropy=ent, approx_kl=kl, grad_steps=it + 1)
            if abs(kl) > 1.5 * self.config.target_kl:
                break
        return stats

    def evaluate(self, n_episodes=None):
        """The mean return of deterministic episodes of ``eval_env``."""
        if self.eval_env is None:
            return None
        n = n_episodes or self.config.eval_episodes
        rets = []
        for _ in range(n):
            ts = self.eval_env.reset()
            total = 0.0
            obs = flatten_obs_dict(ts.observation)
            while not ts.last():
                a = self._act(obs[None], deterministic=True)[0][0]
                ts = self.eval_env.step(a)
                obs = flatten_obs_dict(ts.observation)
                total += float(ts.reward or 0.0)
            rets.append(total)
        return float(np.mean(rets))

    def train(self):
        """``max_epochs`` epochs of a rollout of ``steps_per_epoch`` env
        steps and an update.  Returns each epoch's stats: the losses, the
        KL, the mean reward, and its seconds in all (``time``), in the
        environments (``env_s``), in the policy's actions (``policy_s``)
        and in the update (``update_s``)."""
        cfg = self.config
        obs = self.env.reset()
        if self.opt is None:
            self.init_params(obs)
        n_envs = self.env.num_envs
        steps = max(1, cfg.steps_per_epoch // n_envs)
        buffer = PPOBuffer(obs.shape[1], self.policy.action_size, n_envs,
                           steps, cfg.gamma, cfg.lam)
        history = []
        for epoch in range(cfg.max_epochs):
            self.timing = dict(env_s=0.0, policy_s=0.0)
            t0 = time.perf_counter()
            obs = self.collect_rollout(obs, buffer)
            t1 = time.perf_counter()
            stats = self.update(buffer)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t2 = time.perf_counter()
            stats.update(self.timing, epoch=epoch,
                         mean_reward=float(buffer.rewards.mean()),
                         update_s=t2 - t1, time=t2 - t0,
                         env_steps=steps * n_envs)
            history.append(stats)
            print(f"epoch {epoch}: reward/step "
                  f"{stats['mean_reward']:.4f} loss {stats['loss']:.4f} "
                  f"kl {stats['approx_kl']:.4f} "
                  f"({stats['grad_steps']} steps, {stats['time']:.1f}s)")
        return history
