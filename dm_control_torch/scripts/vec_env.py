"""Vectorised environments with the stable-baselines3 API (counterpart
of ``dm_control_tpu/scripts/vec_env.py``; reference: dm_control/scripts/
vec_env.py).

``DummyVecEnv`` steps dm_env environments one after another in this
process and ``SubprocVecEnv`` one a process; both flatten each
observation dict by sorted key and reset an environment whose episode
ended (its last observation in ``info["terminal_observation"]``).
``TorchVecEnv``, the counterpart of the JAX package's ``JaxVecEnv``,
steps a whole ``rl.batch_env.BatchEnv`` in one call on its model's
device.  Every one returns numpy arrays, as the API does.

``SubprocVecEnv`` starts its workers with ``"spawn"`` by default: a
forked child cannot use CUDA once its parent has, and the environments
may run on the card.  Their factories must then pickle
(``CloudpickleWrapper``: cloudpickle where it is installed, the standard
library's pickle otherwise).
"""

from __future__ import annotations

import abc
import multiprocessing as mp
import pickle

import numpy as np
import torch


def flatten_obs_dict(obs):
    """The observation dict's values, flattened and concatenated in
    sorted-key order, as float32."""
    return np.concatenate([
        np.atleast_1d(np.asarray(obs[k], np.float32)).ravel()
        for k in sorted(obs)])


class VecEnv(abc.ABC):
    """The stable-baselines3 vectorised-environment API."""

    def __init__(self, num_envs, observation_space=None, action_space=None):
        self.num_envs = num_envs
        self.observation_space = observation_space
        self.action_space = action_space

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def step_async(self, actions):
        ...

    @abc.abstractmethod
    def step_wait(self):
        ...

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    @abc.abstractmethod
    def close(self):
        ...

    def get_attr(self, attr_name, indices=None):
        raise NotImplementedError

    def set_attr(self, attr_name, value, indices=None):
        raise NotImplementedError

    def env_method(self, method_name, *args, indices=None, **kwargs):
        raise NotImplementedError

    def seed(self, seed=None):
        raise NotImplementedError


class VecEnvWrapper(VecEnv):
    """A VecEnv that passes every call on to ``venv``."""

    def __init__(self, venv):
        self.venv = venv
        super().__init__(venv.num_envs, venv.observation_space,
                         venv.action_space)

    def reset(self):
        return self.venv.reset()

    def step_async(self, actions):
        self.venv.step_async(actions)

    def step_wait(self):
        return self.venv.step_wait()

    def close(self):
        self.venv.close()

    def get_attr(self, attr_name, indices=None):
        return self.venv.get_attr(attr_name, indices)

    def seed(self, seed=None):
        return self.venv.seed(seed)

    def __getattr__(self, name):
        return getattr(self.venv, name)


class CloudpickleWrapper:
    """Pickles a callable by value: cloudpickle where it is installed, the
    standard library's pickle otherwise."""

    def __init__(self, var):
        self.var = var

    def __getstate__(self):
        try:
            import cloudpickle

            return cloudpickle.dumps(self.var)
        except ImportError:
            return pickle.dumps(self.var)

    def __setstate__(self, var):
        self.var = pickle.loads(var)


def _step_and_reset(env, action):
    """One step of a dm_env environment as (obs, reward, done, info); an
    episode that ends is reset, its last observation kept in the info."""
    ts = env.step(action)
    o = flatten_obs_dict(ts.observation)
    done = ts.last()
    info = {}
    if done:
        info["terminal_observation"] = o
        o = flatten_obs_dict(env.reset().observation)
    return o, ts.reward or 0.0, done, info


class DummyVecEnv(VecEnv):
    """dm_env environments stepped one after another in this process."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        super().__init__(len(self.envs))
        self._actions = None

    def reset(self):
        return np.stack([flatten_obs_dict(e.reset().observation)
                         for e in self.envs])

    def step_async(self, actions):
        self._actions = actions

    def step_wait(self):
        obs, rews, dones, infos = zip(*(
            _step_and_reset(env, a) for env, a in zip(self.envs,
                                                      self._actions)))
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(dones), list(infos))

    def close(self):
        pass

    def get_attr(self, attr_name, indices=None):
        idx = range(self.num_envs) if indices is None else indices
        return [getattr(self.envs[i], attr_name) for i in idx]

    def env_method(self, method_name, *args, indices=None, **kwargs):
        idx = range(self.num_envs) if indices is None else indices
        return [getattr(self.envs[i], method_name)(*args, **kwargs)
                for i in idx]

    def seed(self, seed=None):
        return [seed] * self.num_envs


def _worker(remote, parent_remote, env_fn_wrapper):
    """A worker's loop over commands from its pipe: step, reset, close,
    get_attr and env_method."""
    parent_remote.close()
    env = env_fn_wrapper.var()
    while True:
        try:
            cmd, data = remote.recv()
        except EOFError:
            break
        if cmd == "step":
            remote.send(_step_and_reset(env, data))
        elif cmd == "reset":
            remote.send(flatten_obs_dict(env.reset().observation))
        elif cmd == "close":
            remote.close()
            break
        elif cmd == "get_attr":
            remote.send(getattr(env, data))
        elif cmd == "env_method":
            name, args, kwargs = data
            remote.send(getattr(env, name)(*args, **kwargs))
        else:
            raise NotImplementedError(cmd)


class SubprocVecEnv(VecEnv):
    """One process an environment, started by ``start_method`` ("spawn"
    unless the caller names another)."""

    def __init__(self, env_fns, start_method=None):
        self.waiting = False
        self.closed = False
        n_envs = len(env_fns)
        ctx = mp.get_context(start_method or "spawn")
        self.remotes, self.work_remotes = zip(
            *[ctx.Pipe() for _ in range(n_envs)])
        self.processes = []
        for work_remote, remote, env_fn in zip(
                self.work_remotes, self.remotes, env_fns):
            p = ctx.Process(
                target=_worker,
                args=(work_remote, remote, CloudpickleWrapper(env_fn)),
                daemon=True)
            p.start()
            self.processes.append(p)
            work_remote.close()
        super().__init__(n_envs)

    def reset(self):
        for remote in self.remotes:
            remote.send(("reset", None))
        return np.stack([remote.recv() for remote in self.remotes])

    def step_async(self, actions):
        for remote, action in zip(self.remotes, actions):
            remote.send(("step", action))
        self.waiting = True

    def step_wait(self):
        results = [remote.recv() for remote in self.remotes]
        self.waiting = False
        obs, rews, dones, infos = zip(*results)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(dones), list(infos))

    def close(self):
        if self.closed:
            return
        if self.waiting:
            for remote in self.remotes:
                remote.recv()
        for remote in self.remotes:
            remote.send(("close", None))
        for p in self.processes:
            p.join()
        self.closed = True

    def get_attr(self, attr_name, indices=None):
        idx = range(self.num_envs) if indices is None else indices
        for i in idx:
            self.remotes[i].send(("get_attr", attr_name))
        return [self.remotes[i].recv() for i in idx]

    def env_method(self, method_name, *args, indices=None, **kwargs):
        idx = range(self.num_envs) if indices is None else indices
        for i in idx:
            self.remotes[i].send(
                ("env_method", (method_name, args, kwargs)))
        return [self.remotes[i].recv() for i in idx]

    def seed(self, seed=None):
        return [seed] * self.num_envs


class TorchVecEnv(VecEnv):
    """A ``BatchEnv`` of ``num_envs`` environments behind the VecEnv API
    (the JAX package's ``JaxVecEnv``): every environment steps in one call
    on the model's device, the episodes drawn from a ``torch.Generator``
    seeded with ``seed``; observations are flattened by sorted key to a
    (num_envs, D) float32 array.  The ``BatchEnv`` resets an environment
    at the step after its episode ended."""

    def __init__(self, model, task, num_envs, seed=0, **batch_kwargs):
        from dm_control_torch.rl.batch_env import BatchEnv

        self._env = BatchEnv(model, task, **batch_kwargs)
        self._seed_generator(seed)
        self._state = None
        self._actions = None
        super().__init__(num_envs)

    def _seed_generator(self, seed):
        self._generator = torch.Generator(self._env.model.device)
        self._generator.manual_seed(seed or 0)

    @staticmethod
    def _flat(obs):
        batch = next(iter(obs.values())).shape[0]
        return torch.cat([obs[k].reshape(batch, -1) for k in sorted(obs)],
                         dim=1).to(torch.float32).cpu().numpy()

    def reset(self):
        self._state, ts = self._env.reset(self.num_envs, self._generator)
        return self._flat(ts.observation)

    def step_async(self, actions):
        self._actions = actions

    def step_wait(self):
        m = self._env.model
        action = torch.as_tensor(np.asarray(self._actions), dtype=m.dtype,
                                 device=m.device)
        self._state, ts = self._env.step(self._state, action)
        obs = self._flat(ts.observation)
        dones = (ts.step_type == 2).cpu().numpy()
        return (obs, ts.reward.to(torch.float32).cpu().numpy(), dones,
                [{} for _ in range(self.num_envs)])

    def close(self):
        pass

    def seed(self, seed=None):
        self._seed_generator(seed)
        return [seed] * self.num_envs
