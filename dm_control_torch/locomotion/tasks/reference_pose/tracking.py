"""Mocap tracking (counterpart of
``dm_control_tpu/locomotion/tasks/reference_pose/tracking.py``).

Each episode tracks one clip of a collection from a drawn start frame.
The clips become a bank: every clip padded to the longest and its
reference features (body positions and rotations, centre of mass,
appendages) computed once by the port's own kinematics, in float64 on
the host, then moved to the model's device and type.

The walker's features, the termination error, the reward and every
``walker/reference_*`` observation come from one set of functions over a
batched (Model, Data), which both paths call.  The host hooks
(``composer.Environment``: ``initialize_episode`` draws the clip and its
start on the host, ``after_step`` moves the clip's cursor, the reference
observables) call them at B = 1 on the physics' Data.  On the batched
path (``composer.BatchableTask``) which clip and start frame an
environment tracks is per-environment data (the ``_clip`` and ``_start``
entries of its model diff), and the frame it tracks follows from its
time, so the batch needs no host state.  The clips are a dict of
``Trajectory``s or the path of an HDF5 clip file
(``mocap.loader.HDF5TrajectoryLoader``): the dataset's clips, or every
clip of the file.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch

from dm_control_torch import composer
from dm_control_torch.composer.batch import BatchableTask, task_model
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.locomotion.mocap.types import ClipCollection
from dm_control_torch.locomotion.tasks.reference_pose import rewards as rw
from dm_control_torch.physics import kinematics as kin
from dm_control_torch.physics.model import JointType, make_data

DEFAULT_PHYSICS_TIMESTEP = 0.005

#: the observation keys of the reference-relative family
REFERENCE_OBSERVATION_KEYS = (
    "walker/reference_rel_joints",
    "walker/reference_rel_bodies_pos_global",
    "walker/reference_rel_bodies_quats",
    "walker/reference_rel_bodies_pos_local",
    "walker/reference_ego_bodies_quats",
    "walker/reference_rel_root_quat",
    "walker/reference_rel_root_pos_local",
    "walker/reference_appendages_pos",
)

def _quat_conj(q):
    return torch.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]], -1)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def _quat_diff(source, target):
    """The rotation from ``source`` to ``target``: conj(source) * target."""
    return _quat_mul(_quat_conj(source), target)


def _quat_to_mat3(q):
    """Rotation matrices (..., 3, 3) of quaternions (..., 4)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


class ReferencePosesTask(composer.Task, BatchableTask):
    """Track reference qpos/qvel trajectories (reference
    tracking.py:114-899)."""

    def __init__(self, walker, arena,
                 ref_path_or_trajectories,
                 dataset: Optional[ClipCollection] = None,
                 ref_steps: Sequence[int] = (1, 2, 3, 4, 5),
                 termination_error_threshold: float = 0.3,
                 body_error_multiplier: float = 1.0,
                 min_steps: int = 10,
                 reward_type: str = "termination_reward",
                 physics_timestep: float = DEFAULT_PHYSICS_TIMESTEP,
                 always_init_at_clip_start: bool = False,
                 enabled_reference_observables: Optional[
                     Sequence[str]] = None):
        self._arena = arena
        self._walker = walker
        arena.add_free_entity(walker)
        walker.observables.enable_proprioception()
        if isinstance(ref_path_or_trajectories, dict):
            self._trajectories = dict(ref_path_or_trajectories)
        else:
            from dm_control_torch.locomotion.mocap.loader import (
                HDF5TrajectoryLoader,
            )

            loader = HDF5TrajectoryLoader(ref_path_or_trajectories)
            ids = dataset.ids if dataset else loader.keys()
            self._trajectories = {i: loader.get_trajectory(i) for i in ids}
        self._dataset = dataset or ClipCollection(
            ids=tuple(self._trajectories))
        self._ref_steps = tuple(ref_steps)
        self._termination_error_threshold = termination_error_threshold
        self._body_error_multiplier = body_error_multiplier
        self._min_steps = min_steps
        self._reward_fn = rw.get_reward(reward_type)
        self._always_init_at_clip_start = always_init_at_clip_start
        self._bank = None
        # the host episode's state
        self._clip = None
        self._clip_index = 0
        self._time_step = 0
        self._start_step = 0
        self._clip_end = 0
        self._end_mocap = False
        self._termination_error = 0.0
        self._should_truncate = False
        self._obs_cache = (None, None, None)
        self.last_reward_terms = None
        # the reference observables of the host path; the batched
        # observation has every key, as in the JAX package
        enabled = (tuple(enabled_reference_observables)
                   if enabled_reference_observables is not None
                   else REFERENCE_OBSERVATION_KEYS)
        self._task_observables = collections.OrderedDict()
        for key in REFERENCE_OBSERVATION_KEYS:
            def obs_fn(physics, _key=key):
                return self._host_reference_obs(physics)[_key]
            self._task_observables[key] = Generic(obs_fn)
            self._task_observables[key].enabled = key in enabled
        # a control step advances the clip by one frame: the control
        # timestep is the clips' dt
        dts = {float(t.dt) for t in self._trajectories.values()}
        if len(dts) > 1:
            raise ValueError(f"clips disagree on dt: {sorted(dts)}")
        self.set_timesteps(dts.pop() if dts else 0.03, physics_timestep)

    @property
    def root_entity(self):
        return self._arena

    # -- the walker in the compiled model -------------------------------------

    def _layout(self, m):
        """The walker's addresses in model ``m``: its root free joint, its
        joints, the tracked bodies (the walker's list where it has one,
        else its bodies in id order), the end effectors and appendages
        (the end effectors, then every body named ``*head*``)."""
        return m.cached(("tracking_layout", self._walker.name),
                        lambda: self._build_layout(m))

    def _build_layout(self, m):
        prefix = self._walker.name + "/"
        names = m.names
        root_j = next(j for n, j in names.joint.items()
                      if n.startswith(self._walker.name)
                      and m.jnt_type[j] == JointType.FREE)
        joints = [names.joint[prefix + n]
                  for n in self._walker.observable_joint_names]
        tracked = getattr(self._walker, "mocap_tracking_body_names", None)
        if tracked:
            body_ids = [names.body[prefix + n] for n in tracked]
        else:
            body_ids = sorted(b for n, b in names.body.items()
                              if n.startswith(prefix))
        app_ids = [names.body[prefix + n]
                   for n in self._walker.end_effector_body_names]
        for n, b in names.body.items():
            if n.startswith(prefix) and "head" in n and b not in app_ids:
                app_ids.append(b)
        return dict(
            root_qadr=int(m.jnt_qposadr[root_j]),
            root_dadr=int(m.jnt_dofadr[root_j]),
            root_bid=int(m.jnt_bodyid[root_j]),
            jnt_qadr=[int(m.jnt_qposadr[j]) for j in joints],
            jnt_dadr=[int(m.jnt_dofadr[j]) for j in joints],
            body_ids=body_ids, app_ids=app_ids,
            n_ee=len(self._walker.end_effector_body_names))

    # -- the feature pipeline ---------------------------------------------------

    def _features_from_data(self, m, d):
        """The walker's features (B, ...) from a batched Data."""
        lay = self._layout(m)
        a, v = lay["root_qadr"], lay["root_dadr"]
        root_pos = d.qpos[:, a:a + 3]
        root_quat = d.qpos[:, a + 3:a + 7]
        app = (d.xpos[:, m.idx(lay["app_ids"])]
               - root_pos.unsqueeze(1)) @ _quat_to_mat3(root_quat)
        body_ids = m.idx(lay["body_ids"])
        return {
            "position": root_pos,
            "quaternion": root_quat,
            "joints": d.qpos[:, m.idx(lay["jnt_qadr"])],
            "joints_velocity": d.qvel[:, m.idx(lay["jnt_dadr"])],
            "center_of_mass": d.subtree_com[:, lay["root_bid"]],
            "end_effectors": app[:, :lay["n_ee"]],
            "appendages": app,
            "body_positions": d.xpos[:, body_ids],
            "body_quaternions": d.xquat[:, body_ids],
            "velocity": d.qvel[:, v:v + 3],
            "angular_velocity": d.qvel[:, v + 3:v + 6],
        }

    def _reference_features_at(self, bank, clip, t):
        """The reference features (B, ...) at frame ``t`` (B,) of clip
        ``clip`` (B,), the frame held to the bank."""
        clip = clip.long()
        t = t.long().clamp(0, bank["tmax"] - 1)

        def g(key):
            return bank[key][clip, t]

        app = g("appendages")
        return {
            "position": g("root_pos"),
            "quaternion": g("root_quat"),
            "joints": g("joints"),
            "joints_velocity": g("joints_vel"),
            "center_of_mass": g("com"),
            "end_effectors": app[:, :len(
                self._walker.end_effector_body_names)],
            "appendages": app,
            "body_positions": g("body_pos"),
            "body_quaternions": g("body_quat"),
            "velocity": g("root_vel"),
            "angular_velocity": g("root_angvel"),
        }

    def _termination_error_from(self, wf, rf):
        """(B,): half the body-position error (times the multiplier) plus
        half the joint error, each a mean absolute difference."""
        def mean_abs(x):
            return x.abs().reshape(x.shape[0], -1).mean(-1)

        err_joints = mean_abs(rf["joints"] - wf["joints"])
        err_bodies = mean_abs(rf["body_positions"] - wf["body_positions"])
        return (0.5 * self._body_error_multiplier * err_bodies
                + 0.5 * err_joints)

    def _reference_obs_from(self, m, d, wf, bank, clip, t):
        """The ``walker/reference_*`` observations (B, ...): the reference
        at each of ``ref_steps`` frames ahead, relative to the walker."""
        B = d.qpos.shape[0]
        ks = m.idx(self._ref_steps)
        ts = (t.long().unsqueeze(1) + ks).clamp(0, bank["tmax"] - 1)
        clip = clip.long().unsqueeze(1)

        def g(key):  # (B, K, ...)
            return bank[key][clip, ts]

        rmat = _quat_to_mat3(wf["quaternion"])  # (B, 3, 3)
        rel_joints = g("joints") - wf["joints"].unsqueeze(1)
        rel_bodies = g("body_pos") - wf["body_positions"].unsqueeze(1)
        rel_bodies_local = rel_bodies @ rmat[:, None]
        ref_bquat = g("body_quat")
        rel_bquats = _quat_diff(wf["body_quaternions"].unsqueeze(1),
                                ref_bquat)
        ref_rquat = g("root_quat")  # (B, K, 4)
        ego_bquats = _quat_diff(ref_rquat.unsqueeze(2), ref_bquat)
        rel_rquat = _quat_diff(wf["quaternion"].unsqueeze(1), ref_rquat)
        rel_root_local = (g("root_pos")
                          - wf["position"].unsqueeze(1)) @ rmat

        values = (rel_joints, rel_bodies, rel_bquats, rel_bodies_local,
                  ego_bquats, rel_rquat, rel_root_local, g("appendages"))
        return collections.OrderedDict(
            (k, v.reshape(B, -1))
            for k, v in zip(REFERENCE_OBSERVATION_KEYS, values))

    # -- the clip bank ------------------------------------------------------------

    def _host_bank(self, m=None):
        """The bank as float64 numpy arrays, built once per task: the clips
        padded to the longest (a clip's last frame repeats), the start
        windows, the cumulative weights and the reference features, from
        the port's kinematics on the task's model in float64 on the CPU
        (``m`` where it is one, else the entity tree compiled so).
        Features a clip carries (``body_positions``, ...) replace the
        computed ones."""
        if self._bank is not None:
            return self._bank
        if (m is None or m.device.type != "cpu"
                or m.dtype != torch.float64):
            m = task_model(self, "cpu", torch.float64)
        lay = self._layout(m)
        nq, nv = int(m.nq), int(m.nv)
        ids = list(self._dataset.ids)
        tmax = max(self._trajectories[i].num_steps for i in ids)
        qpos = np.zeros((len(ids), tmax, nq))
        qvel = np.zeros((len(ids), tmax, nv))
        ends = np.zeros(len(ids), np.int32)
        start_low = np.asarray(self._dataset.start_steps
                               or [0] * len(ids), np.int32)
        for k, cid in enumerate(ids):
            clip = self._trajectories[cid]
            for tt in range(clip.num_steps):
                fr = clip.get_timestep_data(tt)
                q = np.asarray(fr["qpos"])
                v = np.asarray(fr.get("qvel", np.zeros(0)))
                nq_c = min(nq, len(q))
                qpos[k, tt, :nq_c] = q[:nq_c]
                if v.size:
                    nv_c = min(nv, len(v))
                    qvel[k, tt, :nv_c] = v[:nv_c]
            qpos[k, clip.num_steps:] = qpos[k, clip.num_steps - 1]
            ends[k] = (self._dataset.end_steps[k]
                       if self._dataset.end_steps else clip.num_steps)
        max_start = np.maximum(
            start_low, ends - self._min_steps - max(self._ref_steps))
        weights = np.asarray(self._dataset.weights
                             or [1.0] * len(ids), float)
        cum = np.cumsum(weights / weights.sum())

        n_clip = len(ids)
        d = make_data(m, n_clip * tmax).replace(
            qpos=torch.as_tensor(qpos.reshape(-1, nq)))
        d = kin.com_pos(m, kin.kinematics(m, d))
        a = lay["root_qadr"]
        app = ((d.xpos[:, lay["app_ids"]] - d.qpos[:, None, a:a + 3])
               @ _quat_to_mat3(d.qpos[:, a + 3:a + 7]))
        jq, jd, dv = lay["jnt_qadr"], lay["jnt_dadr"], lay["root_dadr"]
        bank = {
            "qpos": qpos, "qvel": qvel,
            "ends": ends, "start_low": start_low,
            "max_start": max_start.astype(np.int32),
            "cum": cum, "tmax": tmax,
            "joints": qpos[:, :, jq],
            "joints_vel": qvel[:, :, jd],
            "root_pos": qpos[:, :, a:a + 3],
            "root_quat": qpos[:, :, a + 3:a + 7],
            "root_vel": qvel[:, :, dv:dv + 3],
            "root_angvel": qvel[:, :, dv + 3:dv + 6],
            "body_pos": d.xpos[:, lay["body_ids"]].numpy().reshape(
                n_clip, tmax, -1, 3),
            "body_quat": d.xquat[:, lay["body_ids"]].numpy().reshape(
                n_clip, tmax, -1, 4),
            "com": d.subtree_com[:, lay["root_bid"]].numpy().reshape(
                n_clip, tmax, 3),
            "appendages": app.numpy().reshape(n_clip, tmax, -1, 3),
        }
        stored = {"body_positions": "body_pos",
                  "body_quaternions": "body_quat",
                  "center_of_mass": "com",
                  "appendages": "appendages"}
        for k, cid in enumerate(ids):
            clip = self._trajectories[cid]
            for src, dst in stored.items():
                if src not in clip.keys():
                    continue
                arr = np.asarray(clip[src], np.float64)
                if src == "center_of_mass":
                    arr = arr.reshape(arr.shape[0], -1)[:, :3]
                n = min(arr.shape[0], tmax)
                dest = bank[dst]
                if arr[:n].shape == dest[k, :n].shape:
                    dest[k, :n] = arr[:n]
                    dest[k, n:] = arr[n - 1]
        self._bank = bank
        return bank

    def _clip_bank(self, m):
        """The bank on ``m``'s device: floating arrays in ``m``'s type,
        indices as long; built once per model."""
        def build():
            out = {}
            for k, v in self._host_bank(m).items():
                if k == "tmax":
                    out[k] = v
                elif np.issubdtype(v.dtype, np.floating):
                    out[k] = torch.as_tensor(v, dtype=m.dtype,
                                             device=m.device)
                else:
                    out[k] = torch.as_tensor(v, dtype=torch.long,
                                             device=m.device)
            return out
        return m.cached(("tracking_bank", self), build)

    # -- host path (composer.Environment; reference tracking.py:408-510) ---------

    def _select_clip(self, random_state):
        """Draws the clip by its weight (``choice``), then its start frame
        in its window (``randint``, unless the window is empty or
        ``always_init_at_clip_start``)."""
        weights = np.asarray(self._dataset.weights, float)
        probs = weights / weights.sum()
        idx = random_state.choice(len(self._dataset.ids), p=probs)
        clip = self._trajectories[self._dataset.ids[idx]]
        start_low = self._dataset.start_steps[idx]
        end = (self._dataset.end_steps[idx] if self._dataset.end_steps
               else clip.num_steps)
        max_start = max(start_low,
                        end - self._min_steps - max(self._ref_steps))
        if self._always_init_at_clip_start or max_start <= start_low:
            start = start_low
        else:
            start = random_state.randint(start_low, max_start)
        self._clip = clip
        self._clip_index = idx
        self._start_step = start
        self._time_step = start
        self._clip_end = end

    def initialize_episode(self, physics, random_state):
        self._select_clip(random_state)
        frame = self._clip.get_timestep_data(self._time_step)
        self._set_walker_from_frame(physics, frame)
        self._should_truncate = False
        self._end_mocap = False
        self._update_error(physics)

    def _set_walker_from_frame(self, physics, frame):
        """The clip frame's qpos and qvel written into the physics' Data on
        its device, in its type (as far as the frame and the model both
        reach), then a forward."""
        m = physics.model
        ref_qpos = np.asarray(frame["qpos"])
        ref_qvel = np.asarray(frame.get("qvel", np.zeros(m.nv)))
        n = min(m.nq, len(ref_qpos))
        nv = min(m.nv, len(ref_qvel))
        physics.set_entries("qpos", range(n), ref_qpos[:n])
        physics.set_entries("qvel", range(nv), ref_qvel[:nv])
        physics.mark_as_dirty()
        physics.forward()

    def _host_index(self, physics, value):
        return torch.tensor([value], dtype=torch.long,
                            device=physics.model.device)

    def _host_features(self, physics):
        if physics.is_dirty:
            physics.forward()
        return self._features_from_data(physics.model, physics._data)

    def _host_reference_features(self, physics):
        return self._reference_features_at(
            self._clip_bank(physics.model),
            self._host_index(physics, self._clip_index),
            self._host_index(physics, self._time_step))

    def _host_reference_obs(self, physics):
        """The ``walker/reference_*`` observations of the physics' state
        at the clip's cursor, float64 on the host; computed once for all
        the keys of a state."""
        key = (self._clip_index, self._time_step)
        data, cached_key, obs = self._obs_cache
        if data is physics._data and cached_key == key and not \
                physics.is_dirty:
            return obs
        m = physics.model
        wf = self._host_features(physics)
        obs = {k: np.asarray(v[0].cpu().numpy(), float)
               for k, v in self._reference_obs_from(
                   m, physics._data, wf, self._clip_bank(m),
                   self._host_index(physics, self._clip_index),
                   self._host_index(physics, self._time_step)).items()}
        self._obs_cache = (physics._data, key, obs)
        return obs

    def _update_error(self, physics):
        wf = self._host_features(physics)
        rf = self._host_reference_features(physics)
        self._termination_error = float(
            self._termination_error_from(wf, rf)[0])
        if self._termination_error > self._termination_error_threshold:
            self._should_truncate = True

    def after_step(self, physics, random_state):
        self._time_step += 1
        self._update_error(physics)
        # the clip ends max(ref_steps) + 1 frames early, so the reference
        # observations never run off its end (reference tracking.py:523)
        if self._time_step >= self._clip_end - max(self._ref_steps) - 1:
            self._end_mocap = True

    def get_reward(self, physics):
        """The reward of the state at the cursor; its terms, floats, in
        ``last_reward_terms``."""
        wf = self._host_features(physics)
        out = self._reward_fn(
            termination_error=torch.tensor(
                [self._termination_error], dtype=physics.model.dtype,
                device=physics.model.device),
            termination_error_threshold=self._termination_error_threshold,
            walker_features=wf,
            reference_features=self._host_reference_features(physics))

        def host(v):
            return float(v[0]) if isinstance(v, torch.Tensor) else float(v)

        self.last_reward_terms = (
            None if out.reward_terms is None else collections.OrderedDict(
                (k, host(v)) for k, v in out.reward_terms.items()))
        return host(out.reward)

    def should_terminate_episode(self, physics):
        return self._should_truncate or self._end_mocap

    def get_discount(self, physics):
        return 0.0 if self._should_truncate else 1.0

    # -- batched path (composer.batch.BatchableTask) ------------------------------

    def batch_model_diff(self, m):
        zero = torch.zeros((), dtype=torch.int32, device=m.device)
        return {"_clip": zero, "_start": zero}

    def batch_init(self, m, qpos, qvel, rc, diff):
        """A clip drawn by its weight and a start frame uniform in its
        window (the clip's first frame with ``always_init_at_clip_start``);
        the walker set to that frame's qpos and qvel."""
        bank = self._clip_bank(m)
        cum = bank["cum"]
        idx = torch.searchsorted(cum, rc.rand()).clamp(0, len(cum) - 1)
        lo = bank["start_low"][idx]
        span = (bank["max_start"][idx] - lo).clamp(min=0)
        start = lo + torch.floor(rc.rand() * span).long()
        if self._always_init_at_clip_start:
            start = lo
        qpos = bank["qpos"][idx, start].to(qpos.dtype)
        qvel = bank["qvel"][idx, start].to(qvel.dtype)
        return qpos, qvel, dict(diff, _clip=idx.to(torch.int32),
                                _start=start.to(torch.int32))

    def _batch_tstep(self, m, d):
        """The clip frame each environment tracks now: its start frame
        plus its control steps, counted from its time."""
        k = torch.round(d.time / self.control_timestep).long()
        return m.task_state["_start"].long() + k

    def _batch_reference(self, m, d):
        """(walker features, reference features, termination error)."""
        bank = self._clip_bank(m)
        wf = self._features_from_data(m, d)
        rf = self._reference_features_at(bank, m.task_state["_clip"],
                                         self._batch_tstep(m, d))
        return wf, rf, self._termination_error_from(wf, rf)

    def batch_observation(self, m, d):
        bank = self._clip_bank(m)
        wf = self._features_from_data(m, d)
        obs = collections.OrderedDict()
        obs["walker/joints_pos"] = wf["joints"]
        obs["walker/joints_vel"] = wf["joints_velocity"]
        obs["walker/root_quat"] = wf["quaternion"]
        obs["walker/root_velocity"] = torch.cat(
            [wf["velocity"], wf["angular_velocity"]], -1)
        obs.update(self._reference_obs_from(
            m, d, wf, bank, m.task_state["_clip"], self._batch_tstep(m, d)))
        return obs

    def batch_reward(self, m, d):
        wf, rf, err = self._batch_reference(m, d)
        out = self._reward_fn(
            termination_error=err,
            termination_error_threshold=self._termination_error_threshold,
            walker_features=wf, reference_features=rf)
        reward = out.reward
        if not isinstance(reward, torch.Tensor):  # the debug reward, 0
            reward = torch.full_like(d.time, reward)
        return reward.to(d.qpos.dtype)

    def batch_termination(self, m, d):
        """Truncation (discount 0) past the error threshold; the end of
        the clip ``max(ref_steps) + 1`` frames early (discount 1)."""
        _, _, err = self._batch_reference(m, d)
        truncate = err > self._termination_error_threshold
        bank = self._clip_bank(m)
        end = self._batch_tstep(m, d) >= (
            bank["ends"][m.task_state["_clip"].long()]
            - max(self._ref_steps) - 1)
        discount = torch.where(truncate, torch.zeros_like(d.time),
                               torch.ones_like(d.time))
        return truncate | end, discount


class MultiClipMocapTracking(ReferencePosesTask):
    """Tracking a collection of clips, each drawn by its weight; the CoMic
    reward by default."""

    def __init__(self, walker, arena, ref_path_or_trajectories,
                 dataset=None, reward_type="comic", **kwargs):
        super().__init__(walker, arena, ref_path_or_trajectories,
                         dataset=dataset, reward_type=reward_type, **kwargs)
