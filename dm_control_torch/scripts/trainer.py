"""The behaviour-cloning trainer: a warm-up and cosine learning-rate
schedule, global-norm clipping, AdamW with decay on the weights alone,
checkpoints (counterpart of ``dm_control_tpu/scripts/trainer.py``;
reference: dm_control/scripts/trainer.py:22-140).

The model and its update run on ``device`` (the card unless the caller
asks for the CPU); each batch is copied there once a step.  The optimiser
stands for the JAX trainer's optax chain (``clip_by_global_norm`` then
``adamw`` with a decay mask): the gradients are clipped by
``rl/ppo.py::clip_by_global_norm_`` (optax's rule), and
``torch.optim.AdamW`` holds two parameter groups, the weights of the
``Linear`` layers (flax's ``kernel``s, the only leaves the JAX mask
decays) with ``weight_decay`` and every other parameter (biases,
LayerNorm, ``pos_emb``, ``log_std``) without.  The learning rate is set on
both groups before each step from ``lr_multiplier``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from dm_control_torch.rl.ppo import clip_by_global_norm_
from dm_control_torch.scripts.model import FFNet, init_model


class TrainerConfig:
    """The trainer's settings (reference trainer.py:22-40)."""

    max_epochs = 10
    batch_size = 64
    learning_rate = 3e-4
    betas = (0.9, 0.95)
    grad_norm_clip = 1.0
    weight_decay = 0.1
    lr_decay = False
    warmup_tokens = 375e6
    final_tokens = 260e9
    ckpt_path = None
    num_workers = 0
    seed = 0

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)


def decay_parameter_names(model: nn.Module):
    """The parameters AdamW decays: the weight of every ``Linear`` (a flax
    ``Dense`` kernel); biases, LayerNorm, ``pos_emb`` and ``log_std`` are
    not decayed (reference model.py:234-279)."""
    return {f"{name}.weight" if name else "weight"
            for name, module in model.named_modules()
            if isinstance(module, nn.Linear)}


def lr_multiplier(tokens, config):
    """The token-based schedule (reference trainer.py:99-112): a linear
    warm-up, then a cosine down to 0.1."""
    if tokens < config.warmup_tokens:
        return float(tokens) / float(max(1, config.warmup_tokens))
    progress = float(tokens - config.warmup_tokens) / float(
        max(1, config.final_tokens - config.warmup_tokens))
    return max(0.1, 0.5 * (1.0 + np.cos(np.pi * progress)))


class Trainer:
    """The epoch loop over ``TrajectoryDataset`` splits (reference
    trainer.py:42-140).  Dropout is drawn from the trainer's generator
    (seeded ``config.seed`` on ``device``), where the JAX trainer draws
    from the constant key ``PRNGKey(0)`` at every step (ROADMAP C).

    With ``mesh`` (``dm_control_torch.parallel``, its device the
    trainer's), data parallelism as the JAX trainer's ``data`` axis: the
    parameters are replicated (rank 0's broadcast at ``init``), every rank
    draws the same global batch and takes its rows of it, and the
    gradients are averaged over the ranks before the global-norm clip, so
    each rank makes the same update; the losses reported are the ranks'
    mean."""

    def __init__(self, model, train_dataset, test_dataset, config,
                 mesh=None, *, device="cuda"):
        self.mesh = mesh
        if mesh is not None and torch.device(device) != mesh.device:
            raise ValueError(f"the trainer's device {device} is not the "
                             f"mesh's {mesh.device}")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        self.config = config
        self.tokens = 0
        self.best_loss = float("inf")
        self.optimizer = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

    def init(self):
        """Initialises the model's parameters as flax initialises the JAX
        module's, from the trainer's generator, and builds the
        optimiser.  Returns the model."""
        init_model(self.model, self.generator)
        if self.mesh is not None and self.mesh.distributed:
            # every rank draws the same; rank 0's are the ones kept
            import torch.distributed as dist

            for p in self.model.parameters():
                dist.broadcast(p.data, 0)
        self.build_optimizer()
        return self.model

    def build_optimizer(self):
        """AdamW over the model's parameters as they stand (after ``init``
        or after weights were loaded into them)."""
        config = self.config
        decay = decay_parameter_names(self.model)
        params = dict(self.model.named_parameters())
        groups = [
            {"params": [p for n, p in params.items() if n in decay],
             "weight_decay": config.weight_decay},
            {"params": [p for n, p in params.items() if n not in decay],
             "weight_decay": 0.0}]
        self.optimizer = torch.optim.AdamW(
            groups, lr=config.learning_rate, betas=tuple(config.betas),
            eps=1e-8)

    def _prep(self, obs, act):
        """A numpy batch as tensors on the device in the model's type;
        FFNet takes the first step of each block."""
        dtype = next(self.model.parameters()).dtype
        obs = torch.as_tensor(obs).to(self.device, dtype)
        act = torch.as_tensor(act).to(self.device, dtype)
        if isinstance(self.model, FFNet) and obs.dim() == 3:
            obs, act = obs[:, 0], act[:, 0]
        if self.mesh is not None:  # this rank's rows of the batch
            rows = self.mesh.rows(obs.shape[0])
            obs, act = obs[rows], act[rows]
        return obs, act

    def _mean_over_ranks(self, tensors):
        if self.mesh is not None:
            from dm_control_torch.parallel import all_reduce_mean

            all_reduce_mean(self.mesh, tensors)
        return tensors

    def _train_step(self, obs, act, lr_scale):
        """One update on a batch; returns the loss before it."""
        self.model.train()
        _, loss = self.model(obs, act, deterministic=False,
                             generator=self.generator)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        self._mean_over_ranks([p.grad for p in self.model.parameters()
                               if p.grad is not None])
        clip_by_global_norm_(
            [p for p in self.model.parameters() if p.grad is not None],
            self.config.grad_norm_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.config.learning_rate * lr_scale
        self.optimizer.step()
        return self._mean_over_ranks([loss.detach()])[0]

    @torch.no_grad()
    def _eval_step(self, obs, act):
        self.model.eval()
        return self._mean_over_ranks(
            [self.model(obs, act, deterministic=True)[1]])[0]

    def _epoch_batches(self, dataset, rng):
        """One epoch of batches: with ``num_workers`` > 0 from the native
        prefetch ring (``dm_control_torch/native``: the gather overlaps the
        device step; it raises where g++ cannot build it), else from
        ``dataset.batches``."""
        config = self.config
        if config.num_workers > 0:
            from dm_control_torch.native import PrefetchLoader

            n = max(1, len(dataset) // config.batch_size)
            with PrefetchLoader(dataset, config.batch_size,
                                seed=int(rng.randint(1 << 31)),
                                n_threads=config.num_workers) as loader:
                for _ in range(n):
                    yield loader.next()
            return
        yield from dataset.batches(rng, config.batch_size)

    def run_epoch(self, split, epoch, rng):
        """One epoch of ``split`` ("train" updates, anything else
        evaluates); returns the mean loss."""
        config = self.config
        dataset = (self.train_dataset if split == "train"
                   else self.test_dataset)
        losses = []
        t0 = time.time()
        for obs, act in self._epoch_batches(dataset, rng):
            obs, act = self._prep(obs, act)
            if split == "train":
                if config.lr_decay:
                    self.tokens += int(np.prod(act.shape[:-1])) * (
                        self.mesh.world_size if self.mesh else 1)
                    lr_scale = lr_multiplier(self.tokens, config)
                else:
                    lr_scale = 1.0
                loss = self._train_step(obs, act, lr_scale)
            else:
                loss = self._eval_step(obs, act)
            losses.append(float(loss))
        dt = time.time() - t0
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        print(f"epoch {epoch + 1} {split}: loss {mean_loss:.5f} "
              f"({len(losses)} iters, {dt:.1f}s)")
        return mean_loss

    def save_checkpoint(self):
        """``torch.save`` of the model's state dict (reference
        trainer.py:56-60)."""
        if self.config.ckpt_path is None:
            return
        torch.save(self.model.state_dict(), self.config.ckpt_path)

    def load_checkpoint(self, path=None):
        path = path or self.config.ckpt_path
        self.model.load_state_dict(torch.load(path, map_location=self.device,
                                              weights_only=True))
        return self.model

    def train(self):
        """The epochs (reference trainer.py:62-140): the best loss (the
        test split's where there is one) checkpointed.  Returns
        [(train loss, test loss or None)] per epoch."""
        if self.optimizer is None:
            self.init()
        rng = np.random.RandomState(self.config.seed)
        history = []
        for epoch in range(self.config.max_epochs):
            train_loss = self.run_epoch("train", epoch, rng)
            test_loss = None
            if self.test_dataset is not None:
                test_loss = self.run_epoch("test", epoch, rng)
            good = test_loss if test_loss is not None else train_loss
            if good < self.best_loss:
                self.best_loss = good
                self.save_checkpoint()
            history.append((train_loss, test_loss))
        return history
