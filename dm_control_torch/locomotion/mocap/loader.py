"""Mocap clips: the HDF5 and protobuf clip files, the CMU dataset's path,
and the synthetic clip of tests and benchmarks (counterpart of
``dm_control_tpu/locomotion/mocap/loader.py``; reference:
dm_control/locomotion/mocap/loader.py, cmu_mocap_data.py).

A loader maps clip ids to ``Trajectory``s of numpy arrays: the clips are
host data, which the tracking task turns into a bank on the model's
device.  ``h5py`` and ``protobuf`` are imported only by the loaders that
read and write those files, so the rest of the port needs neither.
The CMU dataset is not fetched: ``cmu_mocap_path`` finds a copy already
on disk.
"""

from __future__ import annotations

import os

import numpy as np

from dm_control_torch.locomotion.mocap.trajectory import Trajectory


class TrajectoryLoader:
    """A source of clips by id."""

    def get_trajectory(self, identifier, start_step=None, end_step=None):
        raise NotImplementedError

    def keys(self):
        raise NotImplementedError


class HDF5TrajectoryLoader(TrajectoryLoader):
    """Clips from an HDF5 file, one top-level group a clip.  A group holds
    either the reference's layout (a ``walkers/walker_0`` subgroup of
    (feature_dim, T) arrays) or a flat one (time-major datasets directly
    under the group); the clip's ``dt`` attribute defaults to 0.03."""

    def __init__(self, path: str, trajectory_class=Trajectory):
        import h5py

        self._path = path
        self._trajectory_class = trajectory_class
        self._file = h5py.File(path, "r")

    def keys(self):
        return list(self._file.keys())

    def get_trajectory(self, identifier: str, start_step=None,
                       end_step=None) -> Trajectory:
        group = self._file[identifier]
        dt = float(group.attrs.get("dt", 0.03))
        if "walkers" in group:
            features = self._decode_reference_clip(group)
        else:
            features = {key: np.asarray(value)
                        for key, value in group.items()}
        traj = self._trajectory_class(features, dt=dt,
                                      identifier=identifier)
        if start_step is not None or end_step is not None:
            traj = traj.sub_trajectory(start_step or 0, end_step)
        return traj

    @staticmethod
    def _decode_reference_clip(group):
        """The reference layout's walker, time-major: the raw features, and
        qpos = [position; quaternion; joints] and qvel = [velocity;
        angular_velocity (zeros where absent); joints_velocity], which the
        tracking task reads; the per-body features reshaped to (T, bodies,
        3 or 4)."""
        w = group["walkers/walker_0"]

        def tm(key):  # (dim, T) -> (T, dim)
            return np.asarray(w[key]).T

        pos, quat, joints = tm("position"), tm("quaternion"), tm("joints")
        vel = tm("velocity")
        angvel = (tm("angular_velocity") if "angular_velocity" in w
                  else np.zeros_like(vel))
        jvel = tm("joints_velocity")
        T = pos.shape[0]
        features = {
            "qpos": np.concatenate([pos, quat, joints], axis=1),
            "qvel": np.concatenate([vel, angvel, jvel], axis=1),
            "position": pos, "quaternion": quat, "joints": joints,
            "joints_velocity": jvel, "velocity": vel,
            "angular_velocity": angvel,
        }
        for key, shape_last in (("center_of_mass", 3),
                                ("end_effectors", 3),
                                ("appendages", 3),
                                ("body_positions", 3),
                                ("body_quaternions", 4)):
            if key in w:
                features[key] = tm(key).reshape(T, -1, shape_last)
        return features


def cmu_mocap_path(version: str = "2019") -> str:
    """The CMU mocap h5 of ``version`` ("2019" or "2020"), looked for in
    ``$CMU_MOCAP_DIR``, then ``~/.dm_control``; FileNotFoundError where it
    is in neither."""
    fname = {"2019": "cmu_2019_08756c01.h5",
             "2020": "cmu_2020_dfe3e9e0.h5"}.get(version)
    for base in (os.environ.get("CMU_MOCAP_DIR"),
                 os.path.expanduser("~/.dm_control")):
        if base and os.path.exists(os.path.join(base, fname)):
            return os.path.join(base, fname)
    raise FileNotFoundError(
        f"CMU mocap dataset {fname} not found. Download it with the "
        f"reference dm_control's cmu_mocap_data fetcher on a networked "
        f"machine and place it in $CMU_MOCAP_DIR or ~/.dm_control.")


def synthetic_walking_trajectory(nq: int, nv: int, num_steps: int = 120,
                                 dt: float = 0.03,
                                 identifier: str = "synthetic_walk",
                                 seed: int = 0) -> Trajectory:
    """A smooth clip: the root walking forward at 0.6 m/s, 1.2 m up,
    upright, and every other joint on a sine of 1 Hz with a drawn phase
    and amplitude (phases first, then amplitudes, from
    ``RandomState(seed)``)."""
    rng = np.random.RandomState(seed)
    t = np.arange(num_steps) * dt
    qpos = np.zeros((num_steps, nq))
    qvel = np.zeros((num_steps, nv))
    qpos[:, 0] = 0.6 * t
    qpos[:, 2] = 1.2
    qpos[:, 3] = 1.0
    phases = rng.uniform(0, 2 * np.pi, max(nq - 7, 0))
    amps = rng.uniform(0.05, 0.3, max(nq - 7, 0))
    for j in range(nq - 7):
        qpos[:, 7 + j] = amps[j] * np.sin(2 * np.pi * t + phases[j])
        qvel[:, 6 + j] = (amps[j] * 2 * np.pi
                          * np.cos(2 * np.pi * t + phases[j]))
    qvel[:, 0] = 0.6
    return Trajectory({"qpos": qpos, "qvel": qvel}, dt=dt,
                      identifier=identifier)


# -- protobuf clip banks ------------------------------------------------------


def trajectory_to_proto(traj: Trajectory):
    """A clip's qpos and qvel (where it has one) as a ``Trajectory``
    message, one ``TimestepData`` a frame."""
    from dm_control_torch.locomotion.mocap.proto import mocap_pb2

    msg = mocap_pb2.Trajectory(identifier=str(traj.identifier),
                               dt=float(traj.dt))
    qpos = np.asarray(traj["qpos"])
    qvel = (np.asarray(traj["qvel"]) if "qvel" in traj.keys()
            else np.zeros((len(qpos), 0)))
    for t in range(len(qpos)):
        ts = msg.timesteps.add()
        ts.qpos.extend(qpos[t].tolist())
        if qvel.shape[1]:
            ts.qvel.extend(qvel[t].tolist())
    return msg


def trajectory_from_proto(msg) -> Trajectory:
    """The clip of a ``Trajectory`` message (either package's)."""
    qpos = np.array([list(ts.qpos) for ts in msg.timesteps])
    features = {"qpos": qpos}
    if msg.timesteps and len(msg.timesteps[0].qvel):
        features["qvel"] = np.array([list(ts.qvel)
                                     for ts in msg.timesteps])
    return Trajectory(features, dt=float(msg.dt),
                      identifier=str(msg.identifier))


def save_trajectory_bank(path: str, trajectories) -> None:
    """Writes {id: Trajectory} (or a sequence of them) to ``path`` as one
    ``TrajectoryBank`` message."""
    from dm_control_torch.locomotion.mocap.proto import mocap_pb2

    bank = mocap_pb2.TrajectoryBank()
    for traj in (trajectories.values()
                 if isinstance(trajectories, dict) else trajectories):
        bank.trajectories.append(trajectory_to_proto(traj))
    with open(path, "wb") as f:
        f.write(bank.SerializeToString())


class ProtoTrajectoryLoader(TrajectoryLoader):
    """Clips from a ``TrajectoryBank`` file, keyed by their identifiers."""

    def __init__(self, path: str, trajectory_class=Trajectory):
        from dm_control_torch.locomotion.mocap.proto import mocap_pb2

        with open(path, "rb") as f:
            bank = mocap_pb2.TrajectoryBank.FromString(f.read())
        self._trajectory_class = trajectory_class
        self._trajectories = {
            str(msg.identifier): trajectory_from_proto(msg)
            for msg in bank.trajectories}

    def keys(self):
        return list(self._trajectories)

    def get_trajectory(self, identifier: str, start_step=None,
                       end_step=None) -> Trajectory:
        traj = self._trajectories[identifier]
        if start_step is not None or end_step is not None:
            traj = traj.sub_trajectory(start_step or 0, end_step)
        return traj
