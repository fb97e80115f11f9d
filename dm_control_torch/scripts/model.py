"""Behaviour-cloning and RL models as ``torch.nn.Module``s (counterpart of
``dm_control_tpu/scripts/model.py``; reference: dm_control/scripts/
model.py).

A minGPT-style causal transformer (``CausalSelfAttention``, ``Block``,
``GPT``), Gaussian policy heads (``GaussianHead``,
``SquashedGaussianHead``), the ``FFNet`` MLP baseline and PPO's
``ActorCritic``, with JSON-serialisable configs.  Each computes what the
JAX package's flax module computes, with flax's conventions where the
libraries differ: ``gelu`` is the tanh approximation, ``LayerNorm``'s
epsilon is 1e-6, a standard deviation is the population's, and a module's
weights are initialised as flax's (``init_model``: LeCun-normal kernels
truncated at two deviations, zero biases).  Every random draw (action
noise, dropout, initialisation) comes from an explicit
``torch.Generator``.  Each model's ``from_flax_params(tree)`` turns the
JAX module's parameter tree (nested dicts of arrays) into its
``state_dict``: a ``Dense`` kernel (in, out) becomes ``weight`` (out, in)
and a ``LayerNorm`` scale its ``weight``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

LOG_STD_MAX = 2.0
LOG_STD_MIN = -20.0
#: flax's LayerNorm epsilon (torch's default is 1e-5)
LAYER_NORM_EPS = 1e-6


@dataclasses.dataclass
class GPTConfig:
    """The transformer's sizes and dropout rates; JSON round-trippable."""

    obs_size: int
    action_size: int
    block_size: int
    n_layer: int = 8
    n_head: int = 8
    n_embd: int = 512
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1

    def to_json(self, output_fname):
        with open(output_fname, "w") as f:
            f.write(json.dumps(dataclasses.asdict(self)))

    @staticmethod
    def from_json(fname):
        with open(fname) as f:
            return GPTConfig(**json.loads(f.read()))


def GPT1Config(obs_size, action_size, block_size, **kw):
    """GPT-1's sizes: 12 layers of 12 heads, 768 wide."""
    kw.setdefault("n_layer", 12)
    kw.setdefault("n_head", 12)
    kw.setdefault("n_embd", 768)
    return GPTConfig(obs_size, action_size, block_size, **kw)


@dataclasses.dataclass
class FFConfig:
    """The MLP baseline's sizes."""

    obs_size: int
    action_size: int
    block_size: int = 1
    hidden_size: int = 1024

    def __post_init__(self):
        assert self.block_size == 1, "FFNet requires block_size=1."

    def to_json(self, output_fname):
        with open(output_fname, "w") as f:
            f.write(json.dumps(dataclasses.asdict(self)))

    @staticmethod
    def from_json(fname):
        with open(fname) as f:
            return FFConfig(**json.loads(f.read()))


# -- flax's conventions -------------------------------------------------------


def _dropout(x, rate, deterministic, generator):
    """flax's ``Dropout``: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate); the mask drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _gaussian_logp(a, mu, std, log_std):
    return torch.sum(-0.5 * ((a - mu) / std) ** 2 - log_std
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def _flatten(tree, prefix=()):
    """A flax parameter tree as {path tuple: array}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def _state_dict(tree, rename):
    """The state dict of a flax tree: ``rename`` maps a module's flax path
    (tuple of names) to its torch prefix; ``kernel`` -> ``weight``
    transposed, ``scale`` -> ``weight``, ``bias`` and parameters of their
    own kept."""
    out = {}
    for path, value in _flatten(tree).items():
        t = torch.as_tensor(np.array(value))
        *module, leaf = path
        prefix = rename(tuple(module))
        if leaf == "kernel":
            name, t = "weight", t.T.contiguous()
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        out[".".join(filter(None, (prefix, name)))] = t
    return out


class _FlaxParams:
    """``from_flax_params(tree)``: the state dict of the JAX module's
    parameters; ``_flax_prefix`` maps a submodule's flax path (a tuple of
    names) to its torch prefix."""

    @staticmethod
    def _flax_prefix(path):
        return ".".join(path)

    @classmethod
    def from_flax_params(cls, tree):
        return _state_dict(tree, cls._flax_prefix)


# -- policy heads -------------------------------------------------------------


class GaussianHead(_FlaxParams, nn.Module):
    """A mean layer (no bias) and a state-independent log-std, initialised
    to -0.5."""

    def __init__(self, in_size, act_dim):
        super().__init__()
        self.mu_layer = nn.Linear(in_size, act_dim, bias=False)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5))

    def forward(self, x, act=None, deterministic=True, generator=None):
        mu = self.mu_layer(x)
        log_std = self.log_std
        std = torch.exp(log_std)
        if deterministic or generator is None:
            pi_action = mu
        else:
            pi_action = mu + std * torch.randn(
                mu.shape, generator=generator, device=mu.device,
                dtype=mu.dtype)
        a = act if act is not None else pi_action
        return (mu, std), pi_action, _gaussian_logp(a, mu, std, log_std)


class SquashedGaussianHead(_FlaxParams, nn.Module):
    """A tanh-squashed Gaussian: mean and log-std layers (no bias), the
    log-std clipped to [LOG_STD_MIN, LOG_STD_MAX], and the log-prob's
    tanh correction (arXiv 1801.01290, appendix C)."""

    def __init__(self, in_size, act_dim, act_limit=1.0):
        super().__init__()
        self.act_limit = act_limit
        self.mu_layer = nn.Linear(in_size, act_dim, bias=False)
        self.log_std_layer = nn.Linear(in_size, act_dim, bias=False)

    def forward(self, x, act=None, deterministic=False, with_logprob=True,
                generator=None):
        mu = self.mu_layer(x)
        log_std = torch.clamp(self.log_std_layer(x), LOG_STD_MIN,
                              LOG_STD_MAX)
        std = torch.exp(log_std)
        if act is None:
            if deterministic or generator is None:
                pi_action = mu
            else:
                pi_action = mu + std * torch.randn(
                    mu.shape, generator=generator, device=mu.device,
                    dtype=mu.dtype)
        else:
            pi_action = act
        logp_pi = None
        if with_logprob:
            logp_pi = _gaussian_logp(pi_action, mu, std, log_std)
            logp_pi = logp_pi - torch.sum(
                2.0 * (math.log(2.0) - pi_action
                       - F.softplus(-2.0 * pi_action)), dim=-1)
        if act is None:
            pi_action = self.act_limit * torch.tanh(pi_action)
        return pi_action, logp_pi


# -- transformer --------------------------------------------------------------


class CausalSelfAttention(_FlaxParams, nn.Module):
    """Multi-head causal self-attention: one qkv projection, the scaled
    product, the causal mask, softmax, the product with v, the output
    projection."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        C = config.n_embd
        self.qkv = nn.Linear(C, 3 * C)
        self.proj = nn.Linear(C, C)

    def forward(self, x, deterministic=True, generator=None):
        cfg = self.config
        B, T, C = x.shape
        nh, hs = cfg.n_head, C // cfg.n_head
        q, k, v = self.qkv(x).split(C, dim=-1)
        q = q.reshape(B, T, nh, hs).transpose(1, 2)
        k = k.reshape(B, T, nh, hs).transpose(1, 2)
        v = v.reshape(B, T, nh, hs).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hs)
        mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        att = torch.where(mask, att, torch.full_like(att, -math.inf))
        att = torch.softmax(att, dim=-1)
        att = _dropout(att, cfg.attn_pdrop, deterministic, generator)
        y = torch.matmul(att, v).transpose(1, 2).reshape(B, T, C)
        return _dropout(self.proj(y), cfg.resid_pdrop, deterministic,
                        generator)


class Block(_FlaxParams, nn.Module):
    """A pre-LN transformer block."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        C = config.n_embd
        self.ln1 = nn.LayerNorm(C, eps=LAYER_NORM_EPS)
        self.attn = CausalSelfAttention(config)
        self.ln2 = nn.LayerNorm(C, eps=LAYER_NORM_EPS)
        self.fc = nn.Linear(C, 4 * C)
        self.proj = nn.Linear(4 * C, C)

    def forward(self, x, deterministic=True, generator=None):
        x = x + self.attn(self.ln1(x), deterministic, generator)
        h = F.gelu(self.fc(self.ln2(x)), approximate="tanh")
        h = _dropout(self.proj(h), self.config.resid_pdrop, deterministic,
                     generator)
        return x + h


class GPT(_FlaxParams, nn.Module):
    """A causal transformer over observation sequences (B, T, obs_size)
    with a squashed Gaussian head: ``forward(obs, targets)`` returns the
    actions and, with targets, the loss -mean log-prob of the targets."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        C = config.n_embd
        self.tok_emb = nn.Linear(config.obs_size, C)
        self.pos_emb = nn.Parameter(torch.zeros(1, config.block_size, C))
        self.blocks = nn.ModuleList(Block(config)
                                    for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(C, eps=LAYER_NORM_EPS)
        self.head = SquashedGaussianHead(C, config.action_size,
                                         act_limit=1.0)

    def forward(self, obs, targets=None, deterministic=True, generator=None):
        cfg = self.config
        B, T, D = obs.shape
        assert T <= cfg.block_size, "block size exhausted"
        x = self.tok_emb(obs) + self.pos_emb[:, :T]
        x = _dropout(x, cfg.embd_pdrop, deterministic, generator)
        for block in self.blocks:
            x = block(x, deterministic, generator)
        x = self.ln_f(x)
        actions, logp = self.head(x, act=targets, deterministic=True,
                                  generator=generator)
        loss = None if targets is None else -torch.mean(logp)
        return actions, loss

    def get_block_size(self):
        return self.config.block_size

    @staticmethod
    def _flax_prefix(path):
        return re.sub(r"^block_(\d+)", r"blocks.\1", ".".join(path))


class FFNet(_FlaxParams, nn.Module):
    """The MLP baseline: two ReLU layers; the loss is the mean squared
    error against the targets."""

    def __init__(self, config: FFConfig):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.fc1 = nn.Linear(config.obs_size, H)
        self.fc2 = nn.Linear(H, H)
        self.out = nn.Linear(H, config.action_size)

    def forward(self, x, targets=None, deterministic=True, generator=None):
        out = self.out(F.relu(self.fc2(F.relu(self.fc1(x)))))
        loss = None
        if targets is not None:
            loss = torch.mean((out - targets) ** 2)
        return out, loss

    @staticmethod
    def _flax_prefix(path):
        return {"Dense_0": "fc1", "Dense_1": "fc2", "Dense_2": "out"}[path[0]]


class ActorCritic(_FlaxParams, nn.Module):
    """PPO's actor-critic: separate two-layer ReLU torsos for the policy
    and the value, a Gaussian head on the policy's.  ``forward`` returns
    ((mu, std), action, value, log-prob)."""

    def __init__(self, obs_size, action_size, hidden_size=64):
        super().__init__()
        self.obs_size, self.action_size = obs_size, action_size
        self.pi_fc1 = nn.Linear(obs_size, hidden_size)
        self.pi_fc2 = nn.Linear(hidden_size, hidden_size)
        self.v_fc1 = nn.Linear(obs_size, hidden_size)
        self.v_fc2 = nn.Linear(hidden_size, hidden_size)
        self.v_out = nn.Linear(hidden_size, 1)
        self.policy_head = GaussianHead(hidden_size, action_size)

    def forward(self, x, act=None, deterministic=False, generator=None):
        z = F.relu(self.pi_fc2(F.relu(self.pi_fc1(x))))
        v = self.v_out(F.relu(self.v_fc2(F.relu(self.v_fc1(x)))))
        pi, a, logp = self.policy_head(z, act=act,
                                       deterministic=deterministic,
                                       generator=generator)
        return pi, a, v.squeeze(-1), logp

    _FLAX = {"Dense_0": "pi_fc1", "Dense_1": "pi_fc2", "Dense_2": "v_fc1",
             "Dense_3": "v_fc2", "Dense_4": "v_out"}

    @classmethod
    def _flax_prefix(cls, path):
        return ".".join((cls._FLAX.get(path[0], path[0]),) + path[1:])


# -- initialisation -----------------------------------------------------------


@torch.no_grad()
def init_model(model: nn.Module, generator: torch.Generator):
    """Initialises ``model``'s parameters as flax initialises the JAX
    module's, drawn from ``generator`` (on the parameters' device): every
    ``Linear`` weight LeCun-normal (a normal of deviation
    1 / sqrt(fan_in), truncated at two deviations), biases and the
    positional embedding zero, ``LayerNorm`` weights one, a Gaussian
    head's log-std -0.5.  Returns the model."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            # flax's variance_scaling(1, "fan_in", "truncated_normal"):
            # the deviation corrected for the truncation
            std = math.sqrt(1.0 / module.in_features) / .87962566103423978
            nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, GaussianHead):
            module.log_std.fill_(-0.5)
        elif isinstance(module, GPT):
            module.pos_emb.zero_()
    return model


def count_params(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))
