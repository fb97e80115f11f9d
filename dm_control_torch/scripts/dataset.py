"""Trajectory dataset for behaviour cloning (counterpart of
``dm_control_tpu/scripts/dataset.py``; reference:
dm_control/scripts/dataset.py:37-160): the HDF5-backed
``TrajectoryDataset`` with short-episode filtering and a *logical offset*
index, so sampled blocks never cross episode boundaries (the head/tail
scheme of dataset.py:87-125).

The whole dataset loads into host numpy once; batches are gathered with
fancy indexing as fixed-shape [B, block_size, D] arrays, which the trainer
copies to the card once a step.  ``h5py`` is imported inside the two
functions that read or write a file.
"""

from __future__ import annotations

import bisect

import numpy as np


class TrajectoryDataset:
    """Block sampler over (observations, actions, dones) arrays."""

    def __init__(self, h5py_file, block_size, observables=None):
        import h5py

        self.block_size = block_size
        with h5py.File(h5py_file, "r") as dset:
            keys = sorted(dset["observables"].keys())
            if observables:
                wanted = []
                for o in observables:
                    if not o.strip():
                        continue
                    if o not in keys and "walker/" + o in keys:
                        o = "walker/" + o
                    if o not in keys:
                        raise ValueError(f"Unrecognized observable: {o}")
                    wanted.append(o)
                keys = sorted(wanted)
            self.observables = keys
            obs = [np.asarray(dset[f"observables/{k}"]) for k in keys]
            self.actions = np.asarray(dset["actions"])
            self.dones = np.asarray(dset["dones"]).astype(bool)
        obs = [o[:, None] if o.ndim == 1 else o.reshape(o.shape[0], -1)
               for o in obs]
        self.observations = np.concatenate(obs, axis=1)

        self._remove_short_episodes()
        self._create_logical_offset()

    @classmethod
    def from_arrays(cls, observations, actions, dones, block_size):
        """Constructs directly from arrays (no HDF5 round trip)."""
        self = cls.__new__(cls)
        self.block_size = block_size
        self.observables = []
        self.observations = np.asarray(observations)
        self.actions = np.asarray(actions)
        self.dones = np.asarray(dones).astype(bool)
        self._remove_short_episodes()
        self._create_logical_offset()
        return self

    def _remove_short_episodes(self):
        """Drops episodes shorter than block_size
        (reference dataset.py:64-85)."""
        episode_ends = np.nonzero(self.dones)[0]
        keep = np.zeros(len(self.dones), bool)
        start = 0
        removed = 0
        for end in episode_ends:
            if end - start + 1 >= self.block_size:
                keep[start:end + 1] = True
            else:
                removed += 1
            start = end + 1
        self.observations = self.observations[keep]
        self.actions = self.actions[keep]
        self.dones = self.dones[keep]
        self.episodes_removed = removed

    def _create_logical_offset(self):
        """Logical→actual index map skipping episode tails
        (reference dataset.py:87-125): a sample at logical index i
        starts a block of ``block_size`` steps guaranteed to lie inside
        one episode."""
        self.logical_index, self.logical_offset = [-1], [0, 0]
        episode_ends = np.nonzero(self.dones)[0]
        start = 0
        head_sum, tail_sum = 0, 0
        for end in episode_ends:
            ep_len = end - start + 1
            assert ep_len >= self.block_size
            tail_start = (end + 1) - self.block_size + 1
            head_steps = tail_start - start
            tail_steps = (end + 1) - tail_start
            head_sum += head_steps
            tail_sum += tail_steps
            self.logical_index.append(head_sum - 1)
            self.logical_offset.append(tail_sum)
            start = end + 1
        self.total_len = head_sum

    @property
    def observation_size(self):
        return self.observations.shape[1]

    @property
    def action_size(self):
        return self.actions.shape[1]

    def __len__(self):
        return self.total_len

    def __getitem__(self, idx):
        """(obs[block,Do], act[block,Da]) for logical index ``idx``
        (reference dataset.py:142-160)."""
        z = bisect.bisect_left(self.logical_index, idx)
        offset = self.logical_offset[z]
        start = idx + offset
        end = start + self.block_size
        return self.observations[start:end], self.actions[start:end]

    def batches(self, rng: np.random.RandomState, batch_size,
                drop_last=True):
        """A shuffled epoch of [B, block, D] batches (the reference's torch
        DataLoader), the order drawn from ``rng``."""
        order = rng.permutation(self.total_len)
        n = (self.total_len // batch_size) if drop_last else (
            (self.total_len + batch_size - 1) // batch_size)
        starts = np.array([
            i + self.logical_offset[
                bisect.bisect_left(self.logical_index, int(i))]
            for i in order])
        window = np.arange(self.block_size)
        for b in range(n):
            idx = starts[b * batch_size:(b + 1) * batch_size]
            gather = idx[:, None] + window[None, :]
            yield self.observations[gather], self.actions[gather]


def write_h5(fname, observables: dict, actions, dones, rewards=None):
    """Writes the dataset layout consumed by TrajectoryDataset
    (reference create_dataset.py output schema)."""
    import h5py

    with h5py.File(fname, "w") as f:
        g = f.create_group("observables")
        for k, v in observables.items():
            g.create_dataset(k, data=np.asarray(v))
        f.create_dataset("actions", data=np.asarray(actions))
        f.create_dataset("dones", data=np.asarray(dones))
        if rewards is not None:
            f.create_dataset("rewards", data=np.asarray(rewards))
