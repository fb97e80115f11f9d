"""Fused scalar-chain fast path: a whole physics step of a small model.

Counterpart of ``dm_control_tpu/physics/fastpath.py`` (``build_step``;
the hybrid ``build_smooth_step`` is not ported).  The general engine is
written over (nbody, ...) arrays with gathers and scatters so that one
code path serves every model; for the small scalar-joint models of the
suite (pendulum, cartpole, acrobot, reacher, walker, cheetah) that
structure costs thousands of device kernels a step for microseconds of
arithmetic.  This module re-derives the same step (the same formulas and
constants as ``engine.step``) for one class of models, checked
statically by ``applicable``: hinge and slide joints only, no tendons,
equalities or activations, joint-transmission actuators with fixed gain
and no bias, contact pairs of the sphere and capsule family (plane-sphere,
plane-capsule, sphere-sphere, sphere-capsule, capsule-capsule) with
condim 1 or 3, Euler or RK4.

``build_step(m)`` returns a ``FastStep``: called with the state of B
environments, it runs ``n_steps`` steps.  A CUDA tensor launches the
kernel of ``csrc/fastpath_step.cu`` (a group of lanes an environment, its
arrays in shared memory, runs all the steps: FK, smooth dynamics, the
constraint rows, the projected Newton solve and the integrator, with no
host sync; ``launch_layout`` sizes the launch); a CPU tensor takes
``FastStep.plain``, the plain PyTorch version of the same step.  The plain
version holds the constraint rows as tensors (J (B, rows, nv), aref and D
(B, rows)), keeps the JAX package's order along the tree's chains, in the
unrolled Cholesky and in the line search, and turns the batched
``while_loop`` into a loop that ends when no environment is live: an
environment that stops early stays frozen, as in JAX.

Reference semantics, as in the JAX module: physics/kinematics.py (FK,
com_pos, com_vel), inertia.py (CRB), dynamics.py (RNE, passive),
actuation.py, constraints.py (limit rows, kbi, pyramidal contact rows),
solver.py (projected Newton with the exact line search), engine.py
(Euler with implicit damping, the RK4 tableau).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from dm_control_torch.physics import collision
from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import (
    BiasType, DisableBit, DynType, GainType, GeomType, IntegratorType,
    JointType, Model, SensorType, TrnType,
)

_MINVAL = 1e-15
_MINIMP, _MAXIMP = 0.0001, 0.9999

#: model_diff fields the fast path takes as per-episode inputs: they only
#: reposition geoms and sites for the observation FK and never enter the
#: dynamics (geom masses were folded into body inertia at compile)
DIFF_SAFE_FIELDS = frozenset(
    {"geom_pos", "geom_quat", "site_pos", "site_quat"})

#: sensor types whose values depend on accelerations or constraint forces
#: computed inside the step: the fast path does not write qacc or contact
#: forces into the Data, so these would read zeros
_ACC_STAGE_SENSORS = frozenset({
    int(SensorType.TOUCH), int(SensorType.ACCELEROMETER),
    int(SensorType.FORCE), int(SensorType.TORQUE),
    int(SensorType.FRAMELINACC), int(SensorType.FRAMEANGACC),
    int(SensorType.ACTUATORFRC)})

_MAX_CONTACT_ROWS = 160  # solver rows; cheetah has 132

#: the colliders the kernel has device functions for, by pair of geom
#: types, with the kernel's number for each (``csrc/fastpath_step.cu``)
COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): 0,
    (GeomType.PLANE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.SPHERE): 2,
    (GeomType.SPHERE, GeomType.CAPSULE): 3,
    (GeomType.CAPSULE, GeomType.CAPSULE): 4,
}


def _np(x) -> np.ndarray:
    return x.detach().cpu().double().numpy()


def _contact_pairs_static(m: Model):
    """Static per-pair contact description, or None where a pair is not
    supported (a collider outside ``COLLIDERS``, a condim other than 1 and
    3): a list of dicts with the collider's key, rows a pair, the geoms,
    condim, friction (5), solref, solimp, includemargin and invweight."""
    try:
        groups = collision.contact_groups(m)
    except NotImplementedError:  # a pair no collider handles (a mesh)
        return None
    out = []
    body_invw = _np(m.body_invweight0)
    for key, nrows, pairs in groups:
        if key not in COLLIDERS:
            return None
        fri, sr, si, incm = (_np(x) for x in collision._pair_params(m, pairs))
        for i, (g1, g2, condim) in enumerate(pairs):
            if condim not in (1, 3):
                return None
            b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
            out.append(dict(key=key, nrows=nrows, g1=int(g1), g2=int(g2),
                            condim=int(condim), friction=fri[i],
                            solref=sr[i], solimp=si[i],
                            includemargin=float(incm[i]),
                            invweight=float(body_invw[b1, 0]
                                            + body_invw[b2, 0])))
    return out


def applicable(m: Model) -> bool:
    """True when the fused step reproduces ``engine.step`` for ``m``: the
    JAX package's rule, every contact pair's collider one of ``COLLIDERS``
    (a model refused for its collider alone runs ``engine.step``), and
    one environment's arrays within a block's shared memory in float64."""
    if m.njnt == 0 or m.nv != m.njnt or m.na != 0:
        return False
    if m.nv > 10 or m.ntendon != 0 or m.neq != 0:
        return False
    if any(t not in (int(JointType.HINGE), int(JointType.SLIDE))
           for t in m.jnt_type):
        return False
    pairs = _contact_pairs_static(m)
    if pairs is None:
        return False
    # a condim 3 contact is 4 pyramidal solver rows
    rows = sum(p["nrows"] * (1 if p["condim"] == 1 else 4) for p in pairs)
    if rows > _MAX_CONTACT_ROWS:
        return False
    # the kernel holds an environment in a block's shared memory (float64)
    rows += 2 * int(np.asarray(m.jnt_limited).sum())
    if env_bytes(m.nbody, m.nv, rows, 8) > MAX_SHARED_BYTES:
        return False
    if any(int(t) in _ACC_STAGE_SENSORS for t in m.sensor_type):
        return False
    if bool((m.dof_frictionloss != 0).any()):
        return False
    for u in range(m.nu):
        if m.actuator_trntype[u] not in (int(TrnType.JOINT),
                                         int(TrnType.JOINTINPARENT)):
            return False
        if m.actuator_dyntype[u] != int(DynType.NONE):
            return False
        if m.actuator_gaintype[u] != int(GainType.FIXED):
            return False
        if m.actuator_biastype[u] != int(BiasType.NONE):
            return False
    if m.opt.integrator not in (int(IntegratorType.EULER),
                                int(IntegratorType.RK4)):
        return False
    # CONTACT (no pairs are grouped), FILTERPARENT (a pair-filter input),
    # CONSTRAINT and LIMIT (their rows are left out, as build_step does)
    harmless = (DisableBit.CONTACT | DisableBit.FILTERPARENT
                | DisableBit.CONSTRAINT | DisableBit.LIMIT)
    if int(m.opt.disableflags) & ~int(harmless):
        return False
    if float(m.opt.density) != 0.0 or float(m.opt.viscosity) != 0.0:
        return False
    if bool((m.opt.wind != 0).any()):
        return False
    return True


# -- the unrolled Cholesky solve --------------------------------------------


def _chol_solve(M: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solves M x = rhs for M (B, n, n) symmetric positive definite (its
    lower triangle is read) and rhs (B, n), in the JAX package's unrolled
    order: each entry of the factor subtracts its products in the order
    k = 0, 1, ...; the pivot is sqrt(max(s, 1e-15)), so a singular system
    gives finite x; the forward substitution subtracts in the order
    k = 0, 1, ... and the backward one in the order k = i + 1, i + 2, ....
    The factor and the forward substitution run a column at a time (every
    entry of a column at once), which computes each entry as the JAX
    package's row-by-row loop does."""
    n = rhs.shape[-1]
    # the factor's columns (B, n); what stands above the diagonal is never
    # read: each step only reads rows at or below its own
    cols = []
    diag = []
    for j, s in enumerate(M.unbind(-1)):
        for k in range(j):
            s = s - cols[k] * cols[k][:, j:j + 1]
        d = torch.sqrt(torch.clamp(s[:, j:j + 1], min=_MINVAL))
        col = s / d
        col[:, j:j + 1] = d
        cols.append(col)
        diag.append(d)
    s = rhs
    y = []
    for i in range(n):
        y.append(s[:, i:i + 1] / diag[i])
        s = s - cols[i] * y[i]
    lower = [c.unbind(-1) for c in cols]  # lower[i][k]: the entry (k, i)
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - lower[i][k].unsqueeze(-1) * x[k]
        x[i] = s / diag[i]
    return torch.cat(x, dim=-1)


def _rotate(v, q):
    """mathx.rotate: v + 2 (w c + u x c), c = u x v."""
    u, v = torch.broadcast_tensors(q[..., 1:], v)
    c = torch.linalg.cross(u, v)
    return v + 2.0 * (q[..., :1] * c + torch.linalg.cross(u, c))


#: the Hamilton product's signs: (u (x) v)_k = sum_ij u_i v_j _QMUL[4 i + j, k]
_QMUL = np.zeros((16, 4))
for (_i, _j, _k, _s) in ((0, 0, 0, 1), (1, 1, 0, -1), (2, 2, 0, -1),
                         (3, 3, 0, -1), (0, 1, 1, 1), (1, 0, 1, 1),
                         (2, 3, 1, 1), (3, 2, 1, -1), (0, 2, 2, 1),
                         (1, 3, 2, -1), (2, 0, 2, 1), (3, 1, 2, 1),
                         (0, 3, 3, 1), (1, 2, 3, 1), (2, 1, 3, -1),
                         (3, 0, 3, 1)):
    _QMUL[4 * _i + _j, _k] = _s


def _quat_mul(u, v, qmul):
    """mathx.quat_mul as one product of the outer product with the signs
    ``qmul`` (``_QMUL`` in the dtype)."""
    u, v = torch.broadcast_tensors(u, v)
    return (u.unsqueeze(-1) * v.unsqueeze(-2)).flatten(-2) @ qmul


def _motion_cross(v, m):
    """mathx.motion_cross."""
    va, vl, ma, ml = v[..., :3], v[..., 3:], m[..., :3], m[..., 3:]
    return torch.cat([torch.linalg.cross(va, ma),
                      torch.linalg.cross(va, ml)
                      + torch.linalg.cross(vl, ma)], dim=-1)


def _force_cross(v, f):
    """mathx.force_cross."""
    va, vl, fa, fl = v[..., :3], v[..., 3:], f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(va, fa)
                      + torch.linalg.cross(vl, fl),
                      torch.linalg.cross(va, fl)], dim=-1)


def _mv(a, x):
    """a @ x over the last dimensions: (..., m, n) and (..., n)."""
    return (a @ x.unsqueeze(-1)).squeeze(-1)


# -- the model's plan --------------------------------------------------------


def _quat_mat_np(q) -> np.ndarray:
    """Rotation matrix of a (w, x, y, z) quaternion, as mathx.quat_to_mat."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _is_unit(q) -> bool:
    return bool(np.allclose(q, [1.0, 0.0, 0.0, 0.0]))


def _kbi_static(solref, solimp, dt: float):
    """The state-free part of ``constraints.kbi`` for one row (the JAX
    module's ``_kbi`` computes it in Python floats): dmin, dmax - dmin,
    max(width, 1e-15), the clamped mid, max(power, 1), whether the solref
    is direct, and the factor of imp in k with b: k = kf imp (direct) or
    imp / kf, b."""
    dmin, dmax, width, mid, power = (float(v) for v in solimp)
    mid_c = min(max(mid, _MINIMP), _MAXIMP)
    dmax_c = min(max(dmax, _MINIMP), _MAXIMP)
    timeconst, dampratio = float(solref[0]), float(solref[1])
    if timeconst <= 0:
        direct, kf, b = 1.0, -timeconst, -dampratio
    else:
        tc = max(timeconst, 2.0 * dt)
        direct = 0.0
        kf = max((dmax_c * tc * dampratio) ** 2, _MINVAL)
        b = 2.0 / max(dmax_c * tc, _MINVAL)
    return [dmin, dmax - dmin, max(width, _MINVAL), mid_c, max(power, 1.0),
            direct, kf, b]


#: the plan's layout: its counts, its int arrays and its float arrays, in
#: the order of the kernel's enums (``fastpath_layout_names()`` in
#: ``csrc/fastpath_step.cu`` returns the same names, and ``_load`` checks)
COUNT_NAMES = ("nbody", "nv", "nu", "nlim", "npair", "nrows", "integrator",
               "iterations", "ls_iterations", "has_damping")
INT_NAMES = ("body_parent", "body_jntadr", "body_jntnum", "body_root",
             "body_quat_unit", "body_iquat_unit", "body_chain", "jnt_type",
             "jnt_qposadr", "jnt_dofadr", "jnt_body", "dof_body",
             "dof_chain", "act_dof", "lim_qposadr", "lim_dofadr",
             "pair_collider", "pair_b1", "pair_b2", "pair_g1_unit",
             "pair_g2_unit", "pair_condim", "pair_row0")
#: (``opt`` holds the timestep, tolerance x meaninertia x max(1, nv) and
#: gravity (3))
FLOAT_NAMES = ("opt", "body_pos", "body_quat", "body_ipos", "body_iquat",
               "body_mass", "body_inertia", "body_subtreemass", "jnt_axis",
               "jnt_pos", "qpos0", "jnt_stiffness", "qpos_spring",
               "dof_damping", "dof_armature", "dof_dtdamping", "act_gear",
               "act_ctrlrange", "act_forcerange", "lim_sign", "lim_bound",
               "lim_margin", "lim_invweight", "lim_kbi", "pair_g1_pos",
               "pair_g1_mat", "pair_g1_size", "pair_g2_pos", "pair_g2_mat",
               "pair_g2_size", "pair_friction", "pair_includemargin",
               "pair_invweight", "pair_invpyr", "pair_kbi")


class FastStep:
    """The fused step of one model; see the module's docstring.

        step = build_step(model)
        qpos, qvel, warm = step(qpos, qvel, warm, ctrl, n_steps)

    ``qpos`` (B, nq), ``qvel`` and ``warm`` (B, nv) (the solver's warm
    start, ``qacc_warmstart``), ``ctrl`` (B, nu), all of one dtype on one
    device; ``ctrl`` stays fixed over the ``n_steps`` steps.  Returns the
    state after them, ``warm`` the last step's qacc (before the implicit
    damping of Euler), as ``engine.step`` leaves ``qacc_warmstart``.
    ``fk_fields`` gives the position-stage fields an observation reads,
    where ``fk_observe_ok`` (a model without sensors)."""

    def __init__(self, m: Model, pairs):
        self.model = m
        self.nv, self.nu, self.nbody = m.nv, m.nu, m.nbody
        self.ngeom, self.nsite = m.ngeom, m.nsite
        self.fk_observe_ok = m.nsensor == 0
        self._build_plan(m, pairs)
        self._consts: Dict = {}
        self._device_plans: Dict = {}
        #: the Newton iterations of each environment over the last call of
        #: ``plain`` (B,)
        self.newton_iterations = None

    # -- the plan, on the host ----------------------------------------------

    def _build_plan(self, m: Model, pairs) -> None:
        nbody, nv, nu = m.nbody, m.nv, m.nu
        dt = float(m.opt.timestep)
        self.dt = dt
        self.integrator = int(m.opt.integrator)
        self.iterations = int(m.opt.iterations)
        self.ls_iterations = min(int(m.opt.ls_iterations), 12)
        meaninertia = float(m.stat.meaninertia)
        self.tol_scale = float(m.opt.tolerance) * meaninertia * max(1, nv)
        self.impratio = float(m.opt.impratio)
        self.parent = list(m.body_parentid)
        self.body_root = list(m.body_rootid)
        self.jnt_type = list(m.jnt_type)
        self.jnt_qposadr = list(m.jnt_qposadr)
        self.jnt_dofadr = list(m.jnt_dofadr)
        self.jnt_bodyid = list(m.jnt_bodyid)
        self.body_joints = [[] for _ in range(nbody)]
        for j in range(m.njnt):
            self.body_joints[self.jnt_bodyid[j]].append(j)
        # the kernel walks a body's joints as a run of joint ids
        for b, js in enumerate(self.body_joints):
            if js and js != list(range(js[0], js[0] + len(js))):
                raise ValueError(f"body {b}'s joints {js} are not "
                                 f"consecutive")

        def chain(b):  # the dofs of b and its ancestors, sorted
            out = []
            while b != 0:
                out.extend(self.jnt_dofadr[j] for j in self.body_joints[b])
                b = self.parent[b]
            return sorted(out)

        self.body_chain = [chain(b) for b in range(nbody)]
        self.dof_body = [0] * nv
        for j in range(m.njnt):
            self.dof_body[self.jnt_dofadr[j]] = self.jnt_bodyid[j]
        self.order = list(range(1, nbody))  # parents first, by compile

        f64 = {k: _np(getattr(m, k)) for k in (
            "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
            "body_inertia", "body_subtreemass", "jnt_axis", "jnt_pos",
            "qpos0", "qpos_spring", "jnt_stiffness", "dof_damping",
            "dof_armature", "dof_invweight0", "jnt_range", "jnt_margin",
            "jnt_solref", "jnt_solimp")}
        self.f64 = f64
        self.body_quat_unit = [_is_unit(q) for q in f64["body_quat"]]
        self.body_pos_zero = [not np.any(x) for x in f64["body_pos"]]
        self.jnt_pos_zero = [not np.any(x) for x in f64["jnt_pos"]]
        self.body_iquat_unit = [_is_unit(q) for q in f64["body_iquat"]]
        self.has_damping = bool(np.any(f64["dof_damping"]))

        # actuators (joint transmission: the joint's dof)
        self.act_dof = [self.jnt_dofadr[m.actuator_trnid[u][0]]
                        for u in range(nu)]
        gear = _np(m.actuator_gear)[:, 0] if nu else np.zeros(0)
        inf = float("inf")
        ctrlrange = _np(m.actuator_ctrlrange) if nu else np.zeros((0, 2))
        forcerange = _np(m.actuator_forcerange) if nu else np.zeros((0, 2))
        # an unlimited control or force is clamped to +-inf: no change
        ctrl_lo_hi = np.array([
            ctrlrange[u] if m.actuator_ctrllimited[u] else [-inf, inf]
            for u in range(nu)]).reshape(nu, 2)
        force_lo_hi = np.array([
            forcerange[u] if m.actuator_forcelimited[u] else [-inf, inf]
            for u in range(nu)]).reshape(nu, 2)
        self.act_gear, self.act_ctrl_lo_hi = gear, ctrl_lo_hi
        self.act_force_lo_hi = force_lo_hi

        dis = int(m.opt.disableflags)
        # limit rows: (qpos address, dof, sign, bound, margin, invweight,
        # kbi statics)
        lims = []
        if not dis & (DisableBit.CONSTRAINT | DisableBit.LIMIT):
            for j in range(m.njnt):
                if not m.jnt_limited[j]:
                    continue
                d = self.jnt_dofadr[j]
                kbi = _kbi_static(f64["jnt_solref"][j], f64["jnt_solimp"][j],
                                  dt)
                for sign, bound in ((1.0, f64["jnt_range"][j, 0]),
                                    (-1.0, f64["jnt_range"][j, 1])):
                    lims.append((self.jnt_qposadr[j], d, sign, float(bound),
                                 float(f64["jnt_margin"][j]),
                                 float(f64["dof_invweight0"][d]), kbi))
        if dis & DisableBit.CONSTRAINT:
            pairs = []
        self.lims = lims
        self.pairs = pairs

        # contact pairs: geoms' local poses, the rows each pair starts at
        geom_pos, geom_quat = _np(m.geom_pos), _np(m.geom_quat)
        geom_size = _np(m.geom_size)
        row = len(lims)
        for p in pairs:
            p["b1"] = m.geom_bodyid[p["g1"]]
            p["b2"] = m.geom_bodyid[p["g2"]]
            p["row0"] = row
            row += p["nrows"] * (1 if p["condim"] == 1 else 4)
            for side in ("1", "2"):
                g = p["g" + side]
                p["g%s_unit" % side] = _is_unit(geom_quat[g])
                p["g%s_pos" % side] = geom_pos[g]
                p["g%s_mat" % side] = _quat_mat_np(geom_quat[g])
                p["g%s_size" % side] = geom_size[g]
            mu0 = float(p["friction"][0])
            inv = p["invweight"]
            p["invpyr"] = (inv + mu0 * mu0 * inv) * 2.0 * mu0 * mu0 \
                / self.impratio
            p["kbi"] = _kbi_static(p["solref"], p["solimp"], dt)
        self.nrows = row

        def bits(dofs):
            return sum(1 << d for d in dofs)

        jadr = [self.body_joints[b][0] if self.body_joints[b] else 0
                for b in range(nbody)]
        ints = dict(
            body_parent=self.parent, body_jntadr=jadr,
            body_jntnum=[len(js) for js in self.body_joints],
            body_root=self.body_root,
            body_quat_unit=[int(u) for u in self.body_quat_unit],
            body_iquat_unit=[int(u) for u in self.body_iquat_unit],
            body_chain=[bits(c) for c in self.body_chain],
            jnt_type=self.jnt_type, jnt_qposadr=self.jnt_qposadr,
            jnt_dofadr=self.jnt_dofadr, jnt_body=self.jnt_bodyid,
            dof_body=self.dof_body,
            dof_chain=[bits([k for k in self.body_chain[self.dof_body[i]]
                             if k <= i]) for i in range(nv)],
            act_dof=self.act_dof,
            lim_qposadr=[x[0] for x in lims], lim_dofadr=[x[1] for x in lims],
            pair_collider=[COLLIDERS[p["key"]] for p in pairs],
            pair_b1=[p["b1"] for p in pairs], pair_b2=[p["b2"] for p in pairs],
            pair_g1_unit=[int(p["g1_unit"]) for p in pairs],
            pair_g2_unit=[int(p["g2_unit"]) for p in pairs],
            pair_condim=[p["condim"] for p in pairs],
            pair_row0=[p["row0"] for p in pairs])
        g = [float(x) for x in _np(m.opt.gravity)]
        floats = dict(
            opt=[dt, self.tol_scale] + g,
            body_pos=f64["body_pos"], body_quat=f64["body_quat"],
            body_ipos=f64["body_ipos"], body_iquat=f64["body_iquat"],
            body_mass=f64["body_mass"], body_inertia=f64["body_inertia"],
            body_subtreemass=np.maximum(f64["body_subtreemass"], _MINVAL),
            jnt_axis=f64["jnt_axis"], jnt_pos=f64["jnt_pos"],
            qpos0=f64["qpos0"], jnt_stiffness=f64["jnt_stiffness"],
            qpos_spring=f64["qpos_spring"], dof_damping=f64["dof_damping"],
            dof_armature=f64["dof_armature"],
            dof_dtdamping=dt * f64["dof_damping"],
            act_gear=gear, act_ctrlrange=ctrl_lo_hi,
            act_forcerange=force_lo_hi,
            lim_sign=[x[2] for x in lims], lim_bound=[x[3] for x in lims],
            lim_margin=[x[4] for x in lims],
            lim_invweight=[x[5] for x in lims],
            lim_kbi=[x[6] for x in lims],
            pair_g1_pos=[p["g1_pos"] for p in pairs],
            pair_g1_mat=[p["g1_mat"] for p in pairs],
            pair_g1_size=[p["g1_size"] for p in pairs],
            pair_g2_pos=[p["g2_pos"] for p in pairs],
            pair_g2_mat=[p["g2_mat"] for p in pairs],
            pair_g2_size=[p["g2_size"] for p in pairs],
            pair_friction=[p["friction"][:2] for p in pairs],
            pair_includemargin=[p["includemargin"] for p in pairs],
            pair_invweight=[p["invweight"] for p in pairs],
            pair_invpyr=[p["invpyr"] for p in pairs],
            pair_kbi=[p["kbi"] for p in pairs])
        counts = dict(nbody=nbody, nv=nv, nu=nu, nlim=len(lims),
                      npair=len(pairs), nrows=self.nrows,
                      integrator=self.integrator, iterations=self.iterations,
                      ls_iterations=self.ls_iterations,
                      has_damping=int(self.has_damping))
        self.plan_ints, self.plan_floats = _pack(counts, ints, floats)
        self.geom_bodyid = list(m.geom_bodyid)
        self.site_bodyid = list(m.site_bodyid)
        self.geom_pos0, self.geom_quat0 = geom_pos, geom_quat
        self.site_pos0 = _np(m.site_pos) if m.nsite else np.zeros((0, 3))
        self.site_quat0 = _np(m.site_quat) if m.nsite else np.zeros((0, 4))

    def _c(self, dtype, device):
        """The plan's constants as tensors of ``dtype`` on ``device``, made
        once each."""
        key = (dtype, device)
        if key not in self._consts:
            f = self.f64

            def t(x):
                return torch.as_tensor(np.asarray(x, np.float64),
                                       dtype=dtype, device=device)

            pairs = self.pairs
            self._consts[key] = dict(
                body_pos=t(f["body_pos"]), body_quat=t(f["body_quat"]),
                body_ipos=t(f["body_ipos"]),
                iquat_mat=t([_quat_mat_np(q) for q in f["body_iquat"]]),
                body_mass=t(f["body_mass"]),
                body_inertia=t(f["body_inertia"]),
                subtreemass=t(np.maximum(f["body_subtreemass"], _MINVAL)),
                jnt_axis=t(f["jnt_axis"]), jnt_pos=t(f["jnt_pos"]),
                qpos0=t(f["qpos0"]), stiffness=t(f["jnt_stiffness"]),
                qpos_spring=t(f["qpos_spring"]),
                neg_damping=t(-f["dof_damping"]),
                armature=t(f["dof_armature"]),
                dtdamping=t(self.dt * f["dof_damping"]),
                gravity=t(_np(self.model.opt.gravity)),
                gear=t(self.act_gear), ctrl_lo_hi=t(self.act_ctrl_lo_hi),
                force_lo_hi=t(self.act_force_lo_hi),
                g1_pos=t([p["g1_pos"] for p in pairs]).reshape(-1, 3),
                g1_mat=t([p["g1_mat"] for p in pairs]).reshape(-1, 3, 3),
                g1_size=t([p["g1_size"] for p in pairs]).reshape(-1, 3),
                g2_pos=t([p["g2_pos"] for p in pairs]).reshape(-1, 3),
                g2_mat=t([p["g2_mat"] for p in pairs]).reshape(-1, 3, 3),
                g2_size=t([p["g2_size"] for p in pairs]).reshape(-1, 3),
                geom_pos=t(self.geom_pos0), site_pos=t(self.site_pos0),
                geom_mat=t([_quat_mat_np(q) for q in self.geom_quat0]
                           ).reshape(-1, 3, 3),
                site_mat=t([_quat_mat_np(q) for q in self.site_quat0]
                           ).reshape(-1, 3, 3),
                qmul=t(_QMUL),
                **self._row_consts(dtype, device),
                **self._index_consts(device))
        return self._consts[key]

    def _index_consts(self, device):
        """The index tensors and masks of the plain version on ``device``."""
        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        nv = self.nv
        mask = np.zeros((nv, nv), bool)
        for i in range(nv):
            for j in self.body_chain[self.dof_body[i]]:
                if j <= i:
                    mask[i, j] = mask[j, i] = True
        runs, start = [], 0
        while start < len(self.pairs):  # runs of pairs of one collider
            key = self.pairs[start]["key"]
            end = start
            while end < len(self.pairs) and self.pairs[end]["key"] == key:
                end += 1
            runs.append((collision._DISPATCH[key][0], slice(start, end),
                         idx([p["b1"] for p in self.pairs[start:end]]),
                         idx([p["b2"] for p in self.pairs[start:end]])))
            start = end
        return dict(
            root=idx(self.body_root),
            jnt_root=idx([self.body_root[b] for b in self.jnt_bodyid]),
            hinge=torch.as_tensor(
                [t == int(JointType.HINGE) for t in self.jnt_type],
                device=device).unsqueeze(-1),
            dof_joint=idx(np.argsort(self.jnt_dofadr)),
            dof_body=idx(self.dof_body), act_dof=idx(self.act_dof),
            geom_body=idx(self.geom_bodyid), site_body=idx(self.site_bodyid),
            m_lower=torch.as_tensor(np.tril(np.ones((nv, nv), bool)),
                                    device=device),
            m_chain=torch.as_tensor(mask, device=device),
            stiff=[j for j in range(nv)
                   if self.f64["jnt_stiffness"][j] != 0],
            runs=runs)

    def _row_consts(self, dtype, device):
        """Static tensors of the constraint rows: the limit rows' and each
        contact's kbi statics, the contacts' chain masks and their
        candidate-row selection."""
        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

        nv = self.nv
        out = {}
        lims = self.lims
        out["lim_qadr"] = t([x[0] for x in lims], torch.long)
        out["lim_dadr"] = t([x[1] for x in lims], torch.long)
        out["lim_sign"] = t([x[2] for x in lims], torch.float64).to(dtype)
        out["lim_bound"] = t([x[3] for x in lims])
        out["lim_margin"] = t([x[4] for x in lims])
        out["lim_invw"] = t([x[5] for x in lims])
        out["lim_kbi"] = t(np.array([x[6] for x in lims]).reshape(-1, 8))
        Jl = np.zeros((len(lims), nv))
        for r, x in enumerate(lims):
            Jl[r, x[1]] = x[2]
        out["lim_J"] = t(Jl)
        # contacts: one entry a contact point (pairs' rows, pair-major)
        con_pair, con_row = [], []
        for i, p in enumerate(self.pairs):
            for r in range(p["nrows"]):
                con_pair.append(i)
                con_row.append(r)
        out["con_pair"] = con_pair
        pp = [self.pairs[i] for i in con_pair]
        c1 = np.zeros((len(pp), nv))
        c2 = np.zeros((len(pp), nv))
        for c, p in enumerate(pp):
            c1[c, self.body_chain[p["b1"]]] = 1.0
            c2[c, self.body_chain[p["b2"]]] = 1.0
        out["con_in1"] = t(c1, torch.bool)
        out["con_in2"] = t(c2, torch.bool)
        out["con_root1"] = t([self.body_root[p["b1"]] for p in pp],
                             torch.long)
        out["con_root2"] = t([self.body_root[p["b2"]] for p in pp],
                             torch.long)
        out["con_kbi"] = t(np.array([p["kbi"] for p in pp]).reshape(-1, 8))
        out["con_incm"] = t([p["includemargin"] for p in pp])
        out["con_inv"] = t([p["invweight"] if p["condim"] == 1
                            else p["invpyr"] for p in pp])
        out["con_mu"] = t(np.array([p["friction"][:2] for p in pp]
                                   ).reshape(-1, 2))
        # the candidate rows of contact c are 5c + (normal, +t1, -t1, +t2,
        # -t2); condim 1 keeps the normal, condim 3 the other four
        sel = []
        for c, p in enumerate(pp):
            sel += [5 * c] if p["condim"] == 1 else \
                [5 * c + k for k in range(1, 5)]
        out["row_sel"] = t(sel, torch.long)
        out["row_con"] = t([s // 5 for s in sel], torch.long)
        return out

    # -- the plain version ----------------------------------------------------

    def _fk(self, qpos, c):
        """FK as per-body values: xpos, xquat (lists over bodies of (B, 3)
        and (B, 4)), and each joint's anchor and axis.  A rotation of a
        zero offset is left out: it is exactly zero."""
        B = qpos.shape[0]
        z3 = qpos.new_zeros(B, 3)
        xpos = [z3] * self.nbody
        xquat = [None] * self.nbody
        xquat[0] = qpos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
        xanchor = [None] * self.nv
        xaxis = [None] * self.nv
        qmul = c["qmul"]
        for b in self.order:
            p = self.parent[b]
            pq = xquat[p]
            pos = xpos[p] if self.body_pos_zero[b] else \
                xpos[p] + _rotate(c["body_pos"][b], pq)
            quat = pq if self.body_quat_unit[b] else \
                _quat_mul(pq, c["body_quat"][b], qmul)
            for j in self.body_joints[b]:
                qadr = self.jnt_qposadr[j]
                jp, ja = c["jnt_pos"][j], c["jnt_axis"][j]
                if self.jnt_type[j] == int(JointType.SLIDE):
                    axis_w = _rotate(ja, quat)
                    pos = pos + axis_w * (qpos[:, qadr]
                                          - c["qpos0"][qadr]).unsqueeze(-1)
                    xanchor[j] = pos if self.jnt_pos_zero[j] else \
                        pos + _rotate(jp, quat)
                    xaxis[j] = axis_w
                else:  # HINGE
                    anchor = pos if self.jnt_pos_zero[j] else \
                        pos + _rotate(jp, quat)
                    half = (qpos[:, qadr] - c["qpos0"][qadr]) * 0.5
                    quat = _quat_mul(quat, torch.cat(
                        [torch.cos(half).unsqueeze(-1),
                         ja * torch.sin(half).unsqueeze(-1)], dim=-1), qmul)
                    pos = anchor if self.jnt_pos_zero[j] else \
                        anchor - _rotate(jp, quat)
                    xanchor[j] = anchor
                    xaxis[j] = _rotate(ja, quat)
            xpos[b] = pos
            xquat[b] = quat
        return xpos, xquat, xanchor, xaxis

    def fk_fields(self, qpos: torch.Tensor, diff: Optional[Dict] = None
                  ) -> Dict[str, torch.Tensor]:
        """The position-stage fields ``engine.fwd_position`` writes that an
        observation reads (body, joint, geom and site frames), each (B,
        n, ...).  ``diff`` may override ``DIFF_SAFE_FIELDS`` per episode
        ((n, ...) or (B, n, ...)); an overriding quaternion is normalized."""
        diff = diff or {}
        c = self._c(qpos.dtype, qpos.device)
        xpos, xquat, xanchor, xaxis = self._fk(qpos, c)
        xpos = torch.stack(xpos, dim=1)
        xquat = torch.stack(xquat, dim=1)
        xmat = mx.quat_to_mat(xquat)
        out = dict(xpos=xpos, xquat=xquat, xmat=xmat,
                   xipos=xpos + mx.mat_vec(xmat, c["body_ipos"]),
                   ximat=xmat @ c["iquat_mat"],
                   jnt_xanchor=torch.stack(xanchor, dim=1),
                   jnt_xaxis=torch.stack(xaxis, dim=1))
        for kind, n in (("geom", self.ngeom), ("site", self.nsite)):
            if not n:
                continue
            b = c[f"{kind}_body"]
            pos = diff.get(f"{kind}_pos")
            pos = c[f"{kind}_pos"] if pos is None else pos.to(qpos.dtype)
            quat = diff.get(f"{kind}_quat")
            mat = c[f"{kind}_mat"] if quat is None else mx.quat_to_mat(
                mx.normalize(quat.to(qpos.dtype)))
            out[f"{kind}_xpos"] = xpos[:, b] + mx.mat_vec(xmat[:, b], pos)
            out[f"{kind}_xmat"] = xmat[:, b] @ mat
        return out

    def _smooth(self, qpos, qvel, ctrl, c):
        """FK, com_pos, CRB with armature, com_vel, RNE, passive forces and
        actuation: (M (B, nv, nv), qfrc_smooth, qacc_smooth, and the
        position-stage values the rows read)."""
        nb, nv = self.nbody, self.nv
        B = qpos.shape[0]
        xpos, xquat, xanchor, xaxis = self._fk(qpos, c)
        xpos = torch.stack(xpos, dim=1)
        xmat = mx.quat_to_mat(torch.stack(xquat, dim=1))
        xipos = xpos + mx.mat_vec(xmat, c["body_ipos"])
        ximat = xmat @ c["iquat_mat"]

        # com_pos: subtree masses summed leaf to root, body by body
        acc = list((c["body_mass"].unsqueeze(-1) * xipos).unbind(1))
        for b in reversed(self.order):
            acc[self.parent[b]] = acc[self.parent[b]] + acc[b]
        scom = torch.stack(acc, dim=1) / c["subtreemass"].unsqueeze(-1)
        cinert = mx.inert_from_body(c["body_mass"], c["body_inertia"],
                                    xipos - scom[:, c["root"]], ximat)
        axis = torch.stack(xaxis, dim=1)
        hinge = c["hinge"]
        cdof = torch.cat([
            torch.where(hinge, axis, torch.zeros_like(axis)),
            torch.where(hinge, torch.linalg.cross(
                axis, scom[:, c["jnt_root"]] - torch.stack(xanchor, dim=1)),
                axis)], dim=-1)[:, c["dof_joint"]]

        # CRB: composite inertias leaf to root, then M over the chains
        crb = list(cinert.unbind(1))
        for b in reversed(self.order):
            crb[self.parent[b]] = crb[self.parent[b]] + crb[b]
        crb = torch.stack(crb, dim=1)
        db = c["dof_body"]
        f = mx.inert_mul(crb[:, db], cdof)
        full = f @ cdof.transpose(-1, -2)
        # M[i][j] for j <= i on i's chain, mirrored above the diagonal
        M = torch.where(c["m_chain"], torch.where(
            c["m_lower"], full, full.transpose(-1, -2)),
            torch.zeros_like(full)) + torch.diag_embed(c["armature"])

        # com_vel and RNE along the chains
        v = [qvel[:, i] for i in range(nv)]
        zero6 = qpos.new_zeros(B, 6)
        cvel = [zero6] * nb
        cacc = [None] * nb
        cacc[0] = torch.cat([qpos.new_zeros(3), -c["gravity"]]).expand(B, 6)
        for b in self.order:
            vel = cvel[self.parent[b]]
            a = cacc[self.parent[b]]
            for j in self.body_joints[b]:
                d = self.jnt_dofadr[j]
                cd = cdof[:, d]
                cdof_dot = _motion_cross(vel, cd)
                vel = vel + cd * v[d].unsqueeze(-1)
                a = a + cdof_dot * v[d].unsqueeze(-1)
            cvel[b] = vel
            cacc[b] = a
        cvel_t = torch.stack(cvel, dim=1)
        cfrc = (mx.inert_mul(cinert, torch.stack(cacc, dim=1))
                + _force_cross(cvel_t, mx.inert_mul(cinert, cvel_t)))
        cfrc = list(cfrc.unbind(1))
        for b in reversed(self.order):
            cfrc[self.parent[b]] = cfrc[self.parent[b]] + cfrc[b]
        qfrc_bias = mx.dot(cdof, torch.stack(cfrc, dim=1)[:, db])

        # passive forces and actuation
        qfrc_passive = c["neg_damping"] * qvel
        stiff = c["stiff"]
        if stiff:
            qa = [self.jnt_qposadr[j] for j in stiff]
            da = [self.jnt_dofadr[j] for j in stiff]
            qfrc_passive = qfrc_passive.clone()
            qfrc_passive[:, da] = qfrc_passive[:, da] - c["stiffness"][stiff] \
                * (qpos[:, qa] - c["qpos_spring"][qa])
        qfrc_act = torch.zeros_like(qvel)
        if self.nu:
            lo_hi = c["ctrl_lo_hi"]
            ctl = torch.minimum(torch.maximum(ctrl, lo_hi[:, 0]), lo_hi[:, 1])
            force = c["gear"] * ctl
            lo_hi = c["force_lo_hi"]
            force = torch.minimum(torch.maximum(force, lo_hi[:, 0]),
                                  lo_hi[:, 1])
            qfrc_act = qfrc_act.index_add(1, c["act_dof"], force)
        qfrc_smooth = qfrc_passive - qfrc_bias + qfrc_act
        qacc_smooth = _chol_solve(M, qfrc_smooth)
        return M, qfrc_smooth, qacc_smooth, (xpos, xmat, cdof, scom)

    @staticmethod
    def _kbi(kbi, pos):
        """constraints.kbi with the row's statics ``kbi`` (n, 8) (see
        ``_kbi_static``) at ``pos`` (B, n): (k, b, imp)."""
        dmin, dspan, width, mid, power, direct, kf, b = kbi.unbind(-1)
        x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
        y_lo = (x / mid) ** power * mid
        y_hi = 1.0 - ((1.0 - x) / (1.0 - mid)) ** power * (1.0 - mid)
        y = torch.where(x < mid, y_lo, y_hi)
        imp = torch.clamp(dmin + y * dspan, _MINIMP, _MAXIMP)
        k = torch.where(direct > 0, kf * imp, imp / kf)
        return k, b.expand_as(k), imp

    def _rows(self, qpos, qvel, ctx, c):
        """The constraint rows: J (B, rows, nv), aref and D (B, rows);
        limit rows first, then each contact pair's rows."""
        B = qpos.shape[0]
        Js, arefs, Ds = [], [], []
        if self.lims:
            sign = c["lim_sign"]
            pos = sign * (qpos[:, c["lim_qadr"]] - c["lim_bound"]) \
                - c["lim_margin"]
            vel = qvel[:, c["lim_dadr"]] * sign
            k, b, imp = self._kbi(c["lim_kbi"], pos)
            arefs.append(-b * vel - k * pos)
            r_reg = torch.clamp((1.0 - imp) / imp * c["lim_invw"],
                                min=_MINVAL)
            Ds.append(torch.where(pos < 0, 1.0 / r_reg,
                                  torch.zeros_like(pos)))
            Js.append(c["lim_J"].expand(B, -1, -1))
        if self.pairs:
            J, aref, D = self._contact_rows(qvel, ctx, c)
            Js.append(J)
            arefs.append(aref)
            Ds.append(D)
        return (torch.cat(Js, dim=1), torch.cat(arefs, dim=1),
                torch.cat(Ds, dim=1))

    def _contact_rows(self, qvel, ctx, c):
        """Pyramidal contact rows (constraints.py ``_contact_rows``): the
        narrowphase runs the general colliders over each group of pairs
        that share one."""
        xpos, xmat, cdof, scom = ctx
        dists, poss, frames = [], [], []
        for fn, sl, b1, b2 in c["runs"]:
            m1 = xmat[:, b1] @ c["g1_mat"][sl]
            m2 = xmat[:, b2] @ c["g2_mat"][sl]
            p1 = xpos[:, b1] + mx.mat_vec(xmat[:, b1], c["g1_pos"][sl])
            p2 = xpos[:, b2] + mx.mat_vec(xmat[:, b2], c["g2_pos"][sl])
            dist, pos, frame = fn(p1, m1, c["g1_size"][sl], p2, m2,
                                  c["g2_size"][sl])
            B = dist.shape[0]
            dists.append(dist.reshape(B, -1))
            poss.append(pos.reshape(B, -1, 3))
            frames.append(frame.reshape(B, -1, 3, 3))
        dist = torch.cat(dists, dim=1)  # (B, C)
        pos = torch.cat(poss, dim=1)
        frame = torch.cat(frames, dim=1)
        # the contact point's jacobian over every dof: (B, C, nv, 3)
        ang, lin = cdof[..., :3].unsqueeze(1), cdof[..., 3:].unsqueeze(1)
        shape = (pos.shape[0], pos.shape[1], self.nv, 3)
        ang = ang.expand(shape)
        j2 = lin + torch.linalg.cross(
            ang, (pos - scom[:, c["con_root2"]]).unsqueeze(2).expand(shape))
        j1 = lin + torch.linalg.cross(
            ang, (pos - scom[:, c["con_root1"]]).unsqueeze(2).expand(shape))
        zero = torch.zeros_like(j1)
        jd = torch.where(c["con_in2"].unsqueeze(-1), j2, zero)
        jd = torch.where(c["con_in1"].unsqueeze(-1), jd - j1, jd)
        jf = frame @ jd.transpose(-1, -2)  # (B, C, 3, nv): n, t1, t2
        jn, jt1, jt2 = jf.unbind(2)
        mu1 = c["con_mu"][:, 0].unsqueeze(-1)
        mu2 = c["con_mu"][:, 1].unsqueeze(-1)
        cand = torch.stack([jn, jn + mu1 * jt1, jn + (-mu1) * jt1,
                            jn + mu2 * jt2, jn + (-mu2) * jt2], dim=2)
        J = cand.reshape(cand.shape[0], -1, self.nv)[:, c["row_sel"]]
        pos_eff = dist - c["con_incm"]
        k, b, imp = self._kbi(c["con_kbi"], pos_eff)
        rc = c["row_con"]
        aref = -b[:, rc] * _mv(J, qvel) \
            - k[:, rc] * pos_eff[:, rc]
        r_reg = torch.clamp((1.0 - imp) / imp * c["con_inv"], min=_MINVAL)
        D = torch.where(pos_eff < 0, 1.0 / r_reg, torch.zeros_like(r_reg))
        return J, aref, D[:, rc]

    def _constraint(self, M, qs, warm, J, aref, D):
        """The projected Newton solve with the exact line search
        (solver.py); returns qacc and qfrc_constraint."""
        Jt = J.transpose(-1, -2)
        zero = torch.zeros_like(D)

        def total_cost(x):
            dx = x - qs
            quad = ((0.5 * dx).unsqueeze(-1) * M * dx.unsqueeze(-2)).sum(
                (-1, -2))
            jar = _mv(J, x) - aref
            cost = torch.where(jar < 0, 0.5 * D * jar * jar, zero)
            return quad + cost.sum(-1)

        c0 = total_cost(qs)
        cw = total_cost(warm)
        x = torch.where((cw < c0).unsqueeze(-1), warm, qs)
        cost = torch.minimum(cw, c0)
        improvement = torch.full_like(cost, float("inf"))
        gnorm = torch.full_like(cost, float("inf"))
        for _ in range(self.iterations):
            live = (improvement > self.tol_scale) & (gnorm > self.tol_scale)
            if not bool(live.any()):
                break
            self.newton_iterations += live.to(self.newton_iterations.dtype)
            jar = _mv(J, x) - aref
            hw = torch.where(jar < 0, D, zero)
            dcost = hw * jar
            grad = _mv(M, x - qs) + _mv(Jt, dcost)
            H = M + (Jt * hw.unsqueeze(-2)) @ J
            p = _chol_solve(H, -grad)
            jp = _mv(J, p)
            jp2 = jp * jp
            mp = _mv(M, p)
            p_mp = (p * mp).sum(-1)
            x_as = x - qs
            alpha = torch.ones_like(cost)
            for _ in range(self.ls_iterations):
                a1 = alpha.unsqueeze(-1)
                jar_a = jar + a1 * jp
                hw_a = torch.where(jar_a < 0, D, zero)
                d1 = ((x_as + a1 * p) * mp).sum(-1) \
                    + (hw_a * jar_a * jp).sum(-1)
                d2 = p_mp + (hw_a * jp2).sum(-1)
                alpha = alpha - d1 / torch.clamp(d2, min=_MINVAL)
            alpha = torch.clamp(alpha, 0.0, 4.0)
            x_try = x + alpha.unsqueeze(-1) * p
            cost_try = total_cost(x_try)
            better = (cost_try < cost) & live
            x = torch.where(better.unsqueeze(-1), x_try, x)
            cost_new = torch.where(better, cost_try, cost)
            improvement = torch.where(live, cost - cost_new, improvement)
            gnorm = torch.where(live, torch.sqrt((grad * grad).sum(-1)),
                                gnorm)
            cost = cost_new
        jar = _mv(J, x) - aref
        return x, -_mv(Jt, torch.where(jar < 0, D, zero) * jar)

    def _forward(self, qpos, qvel, warm, ctrl, c):
        M, qfs, qs, ctx = self._smooth(qpos, qvel, ctrl, c)
        if self.nrows == 0:
            return M, qs, qfs, torch.zeros_like(qs)
        J, aref, D = self._rows(qpos, qvel, ctx, c)
        qacc, qfc = self._constraint(M, qs, warm, J, aref, D)
        return M, qacc, qfs, qfc

    _RK4_A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
    _RK4_B = (1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6)

    def _step1(self, qpos, qvel, warm, ctrl, c):
        dt = self.dt
        M, qacc, qfs, qfc = self._forward(qpos, qvel, warm, ctrl, c)
        warm_new = qacc
        if self.integrator == int(IntegratorType.EULER):
            if self.has_damping:
                Mh = M + torch.diag_embed(c["dtdamping"])
                qacc = _chol_solve(Mh, qfs + qfc)
            qvel_n = qvel + dt * qacc
            return qpos + dt * qvel_n, qvel_n, warm_new
        qvels, qaccs = [qvel], [qacc]
        for arow in self._RK4_A:
            dqvel = sum(a * qa for a, qa in zip(arow, qaccs) if a)
            dvel_pos = sum(a * qv for a, qv in zip(arow, qvels) if a)
            vel_i = qvel + dt * dqvel
            _, qacc_i, _, _ = self._forward(qpos + dt * dvel_pos, vel_i,
                                            warm_new, ctrl, c)
            qvels.append(vel_i)
            qaccs.append(qacc_i)
        dvel = sum(b * qv for b, qv in zip(self._RK4_B, qvels))
        dacc = sum(b * qa for b, qa in zip(self._RK4_B, qaccs))
        return qpos + dt * dvel, qvel + dt * dacc, warm_new

    def plain(self, qpos, qvel, warm, ctrl, n_steps: int = 1):
        """The plain PyTorch version of ``n_steps`` steps, on any device.
        Leaves in ``newton_iterations`` (B,) the Newton iterations each
        environment took over the call's solves."""
        c = self._c(qpos.dtype, qpos.device)
        self.newton_iterations = torch.zeros(qpos.shape[0], dtype=torch.long,
                                             device=qpos.device)
        for _ in range(n_steps):
            qpos, qvel, warm = self._step1(qpos, qvel, warm, ctrl, c)
        return qpos, qvel, warm

    # -- the kernel -----------------------------------------------------------

    def device_plan(self, device: torch.device, dtype: torch.dtype):
        """The plan's two flat buffers on ``device``: int32 and ``dtype``,
        made once each."""
        key = (device, dtype)
        if key not in self._device_plans:
            self._device_plans[key] = (
                torch.as_tensor(self.plan_ints, dtype=torch.int32,
                                device=device),
                torch.as_tensor(self.plan_floats, dtype=dtype,
                                device=device))
        return self._device_plans[key]

    def __call__(self, qpos, qvel, warm, ctrl, n_steps: int = 1):
        if qpos.device.type == "cpu":
            return self.plain(qpos, qvel, warm, ctrl, n_steps)
        return fastpath_step_cuda(self, qpos, qvel, warm, ctrl, n_steps)


def _pack(counts, ints, floats):
    """The plan as two flat arrays: ints = [counts, the offset of each int
    array (into ints), the offset of each float array (into floats), the
    int arrays]; floats = the float arrays, each flattened."""
    head = len(COUNT_NAMES) + len(INT_NAMES) + len(FLOAT_NAMES)
    iparts, off = [], head
    ioffs = []
    for name in INT_NAMES:
        a = np.asarray(ints[name], np.int64).reshape(-1)
        ioffs.append(off)
        iparts.append(a)
        off += a.size
    fparts, foffs, off = [], [], 0
    for name in FLOAT_NAMES:
        a = np.asarray(floats[name], np.float64).reshape(-1)
        foffs.append(off)
        fparts.append(a)
        off += a.size
    plan_ints = np.concatenate(
        [np.array([counts[k] for k in COUNT_NAMES] + ioffs + foffs,
                  np.int64)] + iparts)
    if np.abs(plan_ints).max() >= 2 ** 31:
        raise ValueError("the fast path's plan does not fit int32")
    return plan_ints.astype(np.int32), np.concatenate(fparts)


def build_step(m: Model) -> Optional[FastStep]:
    """The fused step of ``m``, or None where ``applicable`` refuses it;
    made once per model."""
    def make():
        if not applicable(m):
            return None
        return FastStep(m, _contact_pairs_static(m))
    return m.cached("fastpath_step", make)


# -- the CUDA wrapper --------------------------------------------------------

_DTYPES = (torch.float32, torch.float64)
_LIB = None


#: the kernel's threads a block and a block's most dynamic shared memory
#: on an H100 (``csrc/fastpath_step.cu``: kBlockThreads, kMaxSharedBytes)
BLOCK_THREADS = 128
MAX_SHARED_BYTES = 232448
#: an environment's values in shared memory: per body, per dof, the
#: nv-vectors of the step's type and the solver's nv-vectors of double
#: (the kernel's kBodyW, kDofW, kVecs and kSolverVecs)
_BODY_W, _DOF_W, _VECS, _SOLVER_VECS = 60, 18, 17, 10


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def env_bytes(nbody: int, nv: int, nrows: int, itemsize: int) -> int:
    """Shared-memory bytes of one environment in the kernel: of the step's
    type its per-body, per-dof and per-row arrays (J, aref, D), M and its
    vectors; of double, the Newton solve's H, factor, vectors and each
    row's jar and J p; then two lists of row indices (the rows that can
    carry force, and those with force at the Newton iterate).  The same
    count as the library's ``fastpath_env_bytes``."""
    values = nbody * _BODY_W + nv * _DOF_W + nrows * (nv + 2) + nv * nv \
        + _VECS * nv
    solver = 2 * nv * nv + _SOLVER_VECS * nv + 2 * nrows
    return _align16(values * itemsize) + _align16(8 * solver) \
        + _align16(8 * nrows)


def launch_layout(step, dtype: torch.dtype):
    """The kernel's launch for ``step`` (a ``FastStep``, or anything with
    its ``nbody``, ``nv``, ``nrows`` and ``pairs``) in ``dtype``: (group
    width, environments a block, shared bytes a block).

    The width is the lanes that run one environment: a warp where the model
    has contact pairs (tens to hundreds of rows, whose sums and the
    Hessian's entries spread over the lanes), else the smallest power of
    two that is at least nv and 8 (a few rows at most: the lanes hold the
    dofs).  A block holds ``BLOCK_THREADS / width`` environments, fewer
    where their shared memory would pass ``MAX_SHARED_BYTES``.  Raises
    where one environment does not fit a block."""
    nv = step.nv
    width = 32 if step.pairs else max(8, 1 << (nv - 1).bit_length())
    each = env_bytes(step.nbody, nv, step.nrows,
                     torch.empty((), dtype=dtype).element_size())
    envs = min(BLOCK_THREADS // width, MAX_SHARED_BYTES // each)
    if envs < 1:
        raise ValueError(f"fastpath: an environment needs {each} bytes of "
                         f"shared memory, a block has {MAX_SHARED_BYTES}")
    return width, envs, envs * each


def launch_grid(layout, B: int):
    """(blocks, warps) of a launch at batch ``B`` with ``layout`` (from
    ``launch_layout``)."""
    width, envs, _ = layout
    blocks = -(-B // envs)
    return blocks, blocks * -(-(width * envs) // 32)


def _load():
    """Builds (or loads) ``csrc/fastpath_step.cu`` and checks that its
    plan layout is this module's."""
    global _LIB
    if _LIB is None:
        from dm_control_torch.ops import _cuda_build

        lib = _cuda_build.load_library("fastpath_step.cu")
        ptr = ctypes.c_void_p
        for fn in (lib.fastpath_step_f32, lib.fastpath_step_f64):
            fn.argtypes = [ptr] * 9 + [ctypes.c_longlong] \
                + [ctypes.c_int] * 7 + [ptr]
            fn.restype = ctypes.c_int
        lib.fastpath_layout_names.argtypes = []
        lib.fastpath_layout_names.restype = ctypes.c_char_p
        lib.fastpath_env_bytes.argtypes = [ctypes.c_int] * 4
        lib.fastpath_env_bytes.restype = ctypes.c_longlong
        lib.fastpath_error_string.argtypes = [ctypes.c_int]
        lib.fastpath_error_string.restype = ctypes.c_char_p
        want = ";".join(",".join(names) for names in (
            COUNT_NAMES, INT_NAMES, FLOAT_NAMES))
        got = lib.fastpath_layout_names().decode()
        if got != want:
            raise RuntimeError(f"fastpath_step.cu's plan layout {got!r} is "
                               f"not the module's {want!r}")
        for args in ((3, 2, 5, 4), (8, 9, 144, 8), (11, 10, 180, 8)):
            if lib.fastpath_env_bytes(*args) != env_bytes(*args):
                raise RuntimeError(f"fastpath_step.cu's shared bytes of an "
                                   f"environment {args} are not the "
                                   f"module's")
        _LIB = lib
    return _LIB


def build() -> None:
    """Builds (or loads) the CUDA library now rather than on first use."""
    _load()


def fastpath_step_cuda(step: FastStep, qpos, qvel, warm, ctrl,
                       n_steps: int = 1):
    """Launches the fused-step kernel on the current stream: a group of
    lanes an environment (``launch_layout``) runs all ``n_steps`` steps,
    its arrays in shared memory.  Raises on a tensor that is not on one
    CUDA device, not float32 or float64, not contiguous or of the wrong
    shape, and on a launch that is refused.  Counts the launch in
    ``fastpath_step_cuda.launches``."""
    B, nv, nu = qpos.shape[0], step.nv, step.nu
    dev, dtype = qpos.device, qpos.dtype
    for name, x, width in (("qpos", qpos, nv), ("qvel", qvel, nv),
                           ("warm", warm, nv), ("ctrl", ctrl, nu)):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"fastpath_step_cuda: {name} on {x.device}, "
                             f"needs the CUDA device of qpos ({dev})")
        if x.dtype not in _DTYPES or x.dtype != dtype:
            raise TypeError(f"fastpath_step_cuda takes float32 or float64 "
                            f"of one type, got {name} {x.dtype} and qpos "
                            f"{dtype}")
        if tuple(x.shape) != (B, width):
            raise ValueError(f"fastpath_step_cuda: {name} of shape "
                             f"{tuple(x.shape)}, needs ({B}, {width})")
        if not x.is_contiguous():
            raise ValueError(f"fastpath_step_cuda: {name} is not "
                             f"contiguous")
    if n_steps < 0:
        raise ValueError(f"fastpath_step_cuda: n_steps = {n_steps}")
    lib = _load()
    plan_i, plan_f = step.device_plan(dev, dtype)
    out = [torch.empty_like(qpos), torch.empty_like(qvel),
           torch.empty_like(warm)]
    if B == 0:
        return tuple(out)
    width, envs, _ = launch_layout(step, dtype)
    entry = lib.fastpath_step_f64 if dtype == torch.float64 \
        else lib.fastpath_step_f32
    args = (plan_i.data_ptr(), plan_f.data_ptr(), qpos.data_ptr(),
            qvel.data_ptr(), warm.data_ptr(), ctrl.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B,
            int(n_steps), step.nbody, nv, step.nrows, len(step.pairs), width,
            envs,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = entry(*args)
    else:  # a launch goes to the current device: make it qpos's
        with torch.cuda.device(dev):
            err = entry(*args)
    if err != 0:
        raise RuntimeError(
            f"fastpath_step: the kernel at B = {B}, nv = {nv}, {dtype} was "
            f"not launched: CUDA error {err}, "
            + lib.fastpath_error_string(err).decode())
    fastpath_step_cuda.launches += 1
    return tuple(out)


#: launches of the CUDA kernel since the count was last set to 0
fastpath_step_cuda.launches = 0


def reset_launch_count() -> None:
    """Sets ``fastpath_step_cuda.launches`` to 0."""
    fastpath_step_cuda.launches = 0
