"""CMU .amc mocap parsing and conversion to humanoid_CMU qpos/qvel.

The port's own copy of ``dm_control_tpu/suite/utils/parse_amc.py``; it
reads ``physics.model`` only (joint names, addresses and types).
Reference: dm_control/suite/utils/parse_amc.py:46-190 — text parser
(frame-number delimited blocks, `parse` :110-150), per-frame conversion
to MuJoCo qpos (`Amcvals2qpos` :152-190: degree→radian joint map, the
CMU length scale 0.056444, y-up→z-up root transform, XYZ-euler root
quaternion premultiplied by a 90° x rotation), cubic-spline resampling
to the physics timestep and finite-difference qvel (`convert` :46-108).
"""

from __future__ import annotations

import collections

import numpy as np

from dm_control_torch.utils import transformations as tr

MOCAP_DT = 1.0 / 120.0
CONVERSION_LENGTH = 0.056444

_CMU_MOCAP_JOINT_ORDER = (
    'root0', 'root1', 'root2', 'root3', 'root4', 'root5', 'lowerbackrx',
    'lowerbackry', 'lowerbackrz', 'upperbackrx', 'upperbackry',
    'upperbackrz', 'thoraxrx', 'thoraxry', 'thoraxrz', 'lowerneckrx',
    'lowerneckry', 'lowerneckrz', 'upperneckrx', 'upperneckry',
    'upperneckrz', 'headrx', 'headry', 'headrz', 'rclaviclery',
    'rclaviclerz', 'rhumerusrx', 'rhumerusry', 'rhumerusrz', 'rradiusrx',
    'rwristry', 'rhandrx', 'rhandrz', 'rfingersrx', 'rthumbrx', 'rthumbrz',
    'lclaviclery', 'lclaviclerz', 'lhumerusrx', 'lhumerusry', 'lhumerusrz',
    'lradiusrx', 'lwristry', 'lhandrx', 'lhandrz', 'lfingersrx', 'lthumbrx',
    'lthumbrz', 'rfemurrx', 'rfemurry', 'rfemurrz', 'rtibiarx', 'rfootrx',
    'rfootrz', 'rtoesrx', 'lfemurrx', 'lfemurry', 'lfemurrz', 'ltibiarx',
    'lfootrx', 'lfootrz', 'ltoesrx')

Converted = collections.namedtuple('Converted', ['qpos', 'qvel', 'time'])


def parse(file_name):
    """Parses the .amc text format into per-frame value arrays
    (reference parse_amc.py:110-150): each frame is a block starting with
    its 1-based frame number, followed by `name v1 v2 ...` lines."""
    values = []
    frame_vals = None
    with open(file_name) as fid:
        for raw in fid:
            line = raw.strip()
            if not line or line.startswith((':', '#')):
                continue
            tokens = line.split()
            if len(tokens) == 1 and tokens[0].isdigit():
                if frame_vals is not None:
                    values.append(np.asarray(frame_vals, float))
                frame_vals = []
            elif frame_vals is not None:
                frame_vals.extend(float(t) for t in tokens[1:])
    if frame_vals:
        values.append(np.asarray(frame_vals, float))
    return values


def _euler2quat(ax, ay, az):
    """Euler (degrees) → wxyz quaternion, zyx rotation order
    (reference mujoco/math.py:23-56 euler2quat)."""
    return tr.euler_to_quat(np.deg2rad([az, ay, ax]), ordering="ZYX")


class Amcvals2qpos:
    """Converts one .amc frame to qpos (reference parse_amc.py:152-190)."""

    def __init__(self, index2joint, joint_order=_CMU_MOCAP_JOINT_ORDER):
        self.qpos_root_xyz_ind = [0, 1, 2]
        self.root_xyz_transform = np.array(
            [[1, 0, 0], [0, 0, -1], [0, 1, 0]], float) * CONVERSION_LENGTH
        self.qpos_root_quat_ind = [3, 4, 5, 6]
        n = len(index2joint)
        m = len(joint_order)
        amc2qpos = np.zeros((n, m))
        for i in range(n):
            for j in range(m):
                if index2joint[i] == joint_order[j] and (
                        'rx' in index2joint[i] or 'ry' in index2joint[i]
                        or 'rz' in index2joint[i]):
                    amc2qpos[i][j] = 1
        self.amc2qpos_transform = amc2qpos

    def __call__(self, amc_val):
        amc_val_rad = np.deg2rad(amc_val)
        qpos = self.amc2qpos_transform @ amc_val_rad
        qpos[:3] = self.root_xyz_transform @ amc_val[:3]
        quat = _euler2quat(amc_val[3], amc_val[4], amc_val[5])
        quat = tr.quat_mul(_euler2quat(90, 0, 0), quat)
        for i, ind in enumerate(self.qpos_root_quat_ind):
            qpos[ind] = quat[i]
        return qpos


def _quat_vel(q0, q1, dt):
    """Angular velocity taking q0 to q1 over dt (reference
    mujoco/math.py mj_quatdiff + mj_quat2vel)."""
    dq = tr.quat_mul(tr.quat_conj(q0), q1)
    dq = dq / max(np.linalg.norm(dq), 1e-12)
    return np.asarray(tr.quat_to_axisangle(dq)) / dt


def convert(file_name, physics, timestep):
    """Parses + converts + resamples (reference parse_amc.py:46-108).
    Returns Converted(qpos [nq,T], qvel [nv,T-1], time [T])."""
    from scipy import interpolate

    frame_values = parse(file_name)
    m = physics.model
    index2joint = {}
    for name, j in m.names.joint.items():
        adr = int(m.jnt_qposadr[j])
        width = 7 if int(m.jnt_type[j]) == 0 else 1
        short = name.split('/')[-1]
        for ii in range(adr, adr + width):
            index2joint[ii] = short
    idx_list = [index2joint.get(i, '') for i in range(m.nq)]

    transformer = Amcvals2qpos(idx_list)
    qpos_values = np.stack([transformer(f) for f in frame_values])

    time_vals = np.arange(0, len(frame_values) * MOCAP_DT - 1e-8, MOCAP_DT)
    time_vals_new = np.arange(0, len(frame_values) * MOCAP_DT, timestep)
    while time_vals_new[-1] > time_vals[-1]:
        time_vals_new = time_vals_new[:-1]

    resampled = []
    for i in range(qpos_values.shape[1]):
        f = interpolate.splrep(time_vals, qpos_values[:, i])
        resampled.append(interpolate.splev(time_vals_new, f))
    qpos_res = np.stack(resampled)  # nq × T

    qvel_list = []
    for t in range(qpos_res.shape[1] - 1):
        p_t, p_tp1 = qpos_res[:, t], qpos_res[:, t + 1]
        q0 = p_t[3:7] / max(np.linalg.norm(p_t[3:7]), 1e-12)
        q1 = p_tp1[3:7] / max(np.linalg.norm(p_tp1[3:7]), 1e-12)
        qvel_list.append(np.concatenate([
            (p_tp1[:3] - p_t[:3]) / timestep,
            _quat_vel(q0, q1, timestep),
            (p_tp1[7:] - p_t[7:]) / timestep]))
    qvel_res = np.vstack(qvel_list).T
    return Converted(qpos_res, qvel_res, time_vals_new)
