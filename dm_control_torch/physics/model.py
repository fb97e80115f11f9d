"""Model and Data for the batched PyTorch engine.

Counterpart of ``dm_control_tpu/physics/model.py``.  ``Model`` keeps the
JAX model's *static* fields as Python values (ints and nested tuples that
decide which code runs) and holds its numeric fields as tensors on one
device in one floating dtype.  ``Data`` is batch-first: every tensor has
a leading environment dimension ``B``; there is no vmap.

Field names follow the JAX package (and mjModel/mjData), so the two can be
compared field by field.  Models are not compiled here: they are loaded
from a file written by ``model_io`` (see ``tools/export_torch_assets.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Enums (values match MuJoCo's mjtJoint/mjtGeom/... and the JAX package).
# ---------------------------------------------------------------------------


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class TrnType(enum.IntEnum):
    JOINT = 0
    JOINTINPARENT = 1
    SLIDERCRANK = 2
    TENDON = 3
    SITE = 4
    BODY = 5


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3
    MUSCLE = 4


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1
    MUSCLE = 2


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1
    MUSCLE = 2


class IntegratorType(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class SolverType(enum.IntEnum):
    PGS = 0
    CG = 1
    NEWTON = 2


class EqType(enum.IntEnum):
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3
    DISTANCE = 4


class WrapType(enum.IntEnum):
    NONE = 0
    JOINT = 1
    PULLEY = 2
    SITE = 3
    SPHERE = 4
    CYLINDER = 5


class SensorType(enum.IntEnum):
    TOUCH = 0
    ACCELEROMETER = 1
    VELOCIMETER = 2
    GYRO = 3
    FORCE = 4
    TORQUE = 5
    MAGNETOMETER = 6
    RANGEFINDER = 7
    JOINTPOS = 8
    JOINTVEL = 9
    TENDONPOS = 10
    TENDONVEL = 11
    ACTUATORPOS = 12
    ACTUATORVEL = 13
    ACTUATORFRC = 14
    BALLQUAT = 15
    BALLANGVEL = 16
    FRAMEPOS = 17
    FRAMEQUAT = 18
    FRAMEXAXIS = 19
    FRAMEYAXIS = 20
    FRAMEZAXIS = 21
    FRAMELINVEL = 22
    FRAMEANGVEL = 23
    FRAMELINACC = 24
    FRAMEANGACC = 25
    SUBTREECOM = 26
    SUBTREELINVEL = 27
    SUBTREEANGMOM = 28


class ObjType(enum.IntEnum):
    BODY = 1
    XBODY = 2
    JOINT = 3
    GEOM = 5
    SITE = 6
    CAMERA = 7


class DisableBit(enum.IntFlag):
    CONSTRAINT = 1 << 0
    EQUALITY = 1 << 1
    FRICTIONLOSS = 1 << 2
    LIMIT = 1 << 3
    CONTACT = 1 << 4
    PASSIVE = 1 << 5
    GRAVITY = 1 << 6
    CLAMPCTRL = 1 << 7
    WARMSTART = 1 << 8
    FILTERPARENT = 1 << 9
    ACTUATION = 1 << 10
    REFSAFE = 1 << 11


# ---------------------------------------------------------------------------
# Dataclass machinery.
# ---------------------------------------------------------------------------


def static_field(**kwargs):
    """A field holding a Python value that selects code paths."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


class _Replace:
    def replace(self, **updates):
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass
class Option(_Replace):
    """Physics options (mjOption)."""

    timestep: torch.Tensor
    gravity: torch.Tensor
    wind: torch.Tensor
    magnetic: torch.Tensor
    density: torch.Tensor
    viscosity: torch.Tensor
    impratio: torch.Tensor
    tolerance: torch.Tensor
    o_margin: torch.Tensor
    o_solref: torch.Tensor
    o_solimp: torch.Tensor
    integrator: int = static_field(default=int(IntegratorType.EULER))
    cone: int = static_field(default=int(ConeType.PYRAMIDAL))
    solver: int = static_field(default=int(SolverType.NEWTON))
    iterations: int = static_field(default=100)
    ls_iterations: int = static_field(default=50)
    noslip_iterations: int = static_field(default=0)
    disableflags: int = static_field(default=0)
    contact_cap: int = static_field(default=0)


@dataclasses.dataclass
class Statistic(_Replace):
    meaninertia: torch.Tensor
    meanmass: torch.Tensor
    meansize: torch.Tensor
    extent: torch.Tensor
    center: torch.Tensor


class NameMap:
    """Name -> id maps per namespace (host-side only)."""

    SLOTS = ("body", "joint", "geom", "site", "actuator", "sensor", "tendon",
             "camera", "equality")

    def __init__(self, **ns):
        for slot in self.SLOTS:
            setattr(self, slot, dict(ns.get(slot, {})))

    def __eq__(self, other):
        return isinstance(other, NameMap) and vars(self) == vars(other)


_T = Optional[torch.Tensor]


@dataclasses.dataclass(eq=False)
class Model(_Replace):
    """The compiled physics model (mjModel), tensors on ``device``."""

    nq: int = static_field()
    nv: int = static_field()
    nu: int = static_field()
    na: int = static_field()
    nbody: int = static_field()
    njnt: int = static_field()
    ngeom: int = static_field()
    nsite: int = static_field()
    ntendon: int = static_field()
    nwrap: int = static_field()
    nsensor: int = static_field()
    nsensordata: int = static_field()
    neq: int = static_field()
    ncam: int = static_field()

    opt: Option = None
    stat: Statistic = None

    qpos0: _T = None
    qpos_spring: _T = None

    body_parentid: Tuple[int, ...] = static_field(default=())
    body_rootid: Tuple[int, ...] = static_field(default=())
    body_weldid: Tuple[int, ...] = static_field(default=())
    body_jntadr: Tuple[int, ...] = static_field(default=())
    body_jntnum: Tuple[int, ...] = static_field(default=())
    body_dofadr: Tuple[int, ...] = static_field(default=())
    body_dofnum: Tuple[int, ...] = static_field(default=())
    body_geomadr: Tuple[int, ...] = static_field(default=())
    body_geomnum: Tuple[int, ...] = static_field(default=())
    body_pos: _T = None
    body_quat: _T = None
    body_ipos: _T = None
    body_iquat: _T = None
    body_mass: _T = None
    body_subtreemass: _T = None
    body_inertia: _T = None
    body_invweight0: _T = None

    jnt_type: Tuple[int, ...] = static_field(default=())
    jnt_qposadr: Tuple[int, ...] = static_field(default=())
    jnt_dofadr: Tuple[int, ...] = static_field(default=())
    jnt_bodyid: Tuple[int, ...] = static_field(default=())
    jnt_limited: Tuple[int, ...] = static_field(default=())
    jnt_axis: _T = None
    jnt_pos: _T = None
    jnt_range: _T = None
    jnt_margin: _T = None
    jnt_stiffness: _T = None
    jnt_springdamper: Tuple[Tuple[float, float], ...] = static_field(
        default=())
    jnt_solref: _T = None
    jnt_solimp: _T = None

    dof_bodyid: Tuple[int, ...] = static_field(default=())
    dof_jntid: Tuple[int, ...] = static_field(default=())
    dof_parentid: Tuple[int, ...] = static_field(default=())
    dof_armature: _T = None
    dof_damping: _T = None
    dof_frictionloss: _T = None
    dof_invweight0: _T = None
    dof_solref: _T = None
    dof_solimp: _T = None

    geom_type: Tuple[int, ...] = static_field(default=())
    geom_contype: Tuple[int, ...] = static_field(default=())
    geom_conaffinity: Tuple[int, ...] = static_field(default=())
    geom_condim: Tuple[int, ...] = static_field(default=())
    geom_bodyid: Tuple[int, ...] = static_field(default=())
    geom_priority: Tuple[int, ...] = static_field(default=())
    geom_size: _T = None
    geom_rbound: _T = None
    geom_pos: _T = None
    geom_quat: _T = None
    geom_friction: _T = None
    geom_margin: _T = None
    geom_gap: _T = None
    geom_solmix: _T = None
    geom_solref: _T = None
    geom_solimp: _T = None
    geom_rgba: _T = None

    nhfield: int = static_field(default=0)
    hfield_nrow: int = static_field(default=0)
    hfield_ncol: int = static_field(default=0)
    geom_dataid: Tuple[int, ...] = static_field(default=())
    hfield_size: _T = None
    hfield_data: _T = None
    nmesh: int = static_field(default=0)
    mesh_kdop: _T = None

    cam_bodyid: Tuple[int, ...] = static_field(default=())
    cam_mode: Tuple[int, ...] = static_field(default=())
    cam_targetbodyid: Tuple[int, ...] = static_field(default=())
    cam_pos: _T = None
    cam_quat: _T = None
    cam_fovy: _T = None
    cam_pos0: _T = None
    cam_poscom0: _T = None
    cam_mat0: _T = None

    site_type: Tuple[int, ...] = static_field(default=())
    site_bodyid: Tuple[int, ...] = static_field(default=())
    site_size: _T = None
    site_pos: _T = None
    site_quat: _T = None

    tendon_adr: Tuple[int, ...] = static_field(default=())
    tendon_num: Tuple[int, ...] = static_field(default=())
    tendon_limited: Tuple[int, ...] = static_field(default=())
    tendon_range: _T = None
    tendon_margin: _T = None
    tendon_stiffness: _T = None
    tendon_damping: _T = None
    tendon_lengthspring: _T = None
    tendon_solref_lim: _T = None
    tendon_solimp_lim: _T = None
    tendon_length0: _T = None
    tendon_invweight0: _T = None
    wrap_type: Tuple[int, ...] = static_field(default=())
    wrap_objid: Tuple[int, ...] = static_field(default=())
    wrap_prm: _T = None

    actuator_trntype: Tuple[int, ...] = static_field(default=())
    actuator_dyntype: Tuple[int, ...] = static_field(default=())
    actuator_gaintype: Tuple[int, ...] = static_field(default=())
    actuator_biastype: Tuple[int, ...] = static_field(default=())
    actuator_trnid: Tuple[Tuple[int, int], ...] = static_field(default=())
    actuator_actadr: Tuple[int, ...] = static_field(default=())
    actuator_actnum: Tuple[int, ...] = static_field(default=())
    actuator_ctrllimited: Tuple[int, ...] = static_field(default=())
    actuator_forcelimited: Tuple[int, ...] = static_field(default=())
    actuator_dynprm: _T = None
    actuator_gainprm: _T = None
    actuator_biasprm: _T = None
    actuator_ctrlrange: _T = None
    actuator_forcerange: _T = None
    actuator_gear: _T = None

    sensor_type: Tuple[int, ...] = static_field(default=())
    sensor_objtype: Tuple[int, ...] = static_field(default=())
    sensor_objid: Tuple[int, ...] = static_field(default=())
    sensor_adr: Tuple[int, ...] = static_field(default=())
    sensor_dim: Tuple[int, ...] = static_field(default=())
    sensor_cutoff: _T = None

    eq_type: Tuple[int, ...] = static_field(default=())
    eq_obj1id: Tuple[int, ...] = static_field(default=())
    eq_obj2id: Tuple[int, ...] = static_field(default=())
    eq_active0: Tuple[int, ...] = static_field(default=())
    eq_solref: _T = None
    eq_solimp: _T = None
    eq_data: _T = None

    body_tree_levels: Tuple[Tuple[int, ...], ...] = static_field(default=())
    collision_pairs: Tuple[Tuple[int, int], ...] = static_field(default=())
    dof_ancestor_mask: _T = None
    body_chain_mask: _T = None

    names: Any = static_field(default=None)
    task_state: Any = None

    # Derived constants (index tensors, masks, schedules) built once per
    # model on its device; not part of the saved model.
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    def cached(self, key, build):
        """Returns ``build()``, computed once per model and ``key``."""
        try:
            return self._cache[key]
        except KeyError:
            value = self._cache[key] = build()
            return value

    def derived(self, key, field: str, build):
        """``build()`` of a value derived from the tensor ``field``, kept
        while the model's ``field`` is the tensor it came from.  A model
        that overrides the field (``rl.control.DIFF_FIELDS``) shares this
        cache, and there ``build()`` runs anew on every call."""
        tensor = getattr(self, field)
        own, value = self.cached(("derived", key), lambda: (tensor, build()))
        return value if own is tensor else build()

    def replace_sharing_cache(self, **updates) -> "Model":
        """``replace`` that keeps this model's cache: only for fields that
        no cached constant derives from (``rl.control.DIFF_FIELDS``; see
        ``derived``)."""
        new = self.replace(**updates)
        new._cache = self._cache
        return new

    def idx(self, seq) -> torch.Tensor:
        """A long index tensor on the model's device (cached by value)."""
        seq = tuple(int(i) for i in np.asarray(seq).reshape(-1))
        return self.cached(("idx", seq), lambda: torch.tensor(
            seq, dtype=torch.long, device=self.device))

    def const(self, key, array) -> torch.Tensor:
        """A floating constant from a host array, cached under ``key``."""
        return self.cached(("const", key), lambda: torch.as_tensor(
            np.asarray(array), dtype=self.dtype, device=self.device))


@dataclasses.dataclass
class Contact(_Replace):
    """Fixed-size contact arrays (mjContact), batch-first: one row per
    candidate the static broadphase admits; rows beyond their margin stay
    with zero force."""

    dist: torch.Tensor  # (B, ncon)
    pos: torch.Tensor  # (B, ncon, 3)
    frame: torch.Tensor  # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
    includemargin: torch.Tensor  # (B, ncon)
    friction: torch.Tensor  # (B, ncon, 5)
    solref: torch.Tensor  # (B, ncon, 2)
    solimp: torch.Tensor  # (B, ncon, 5)
    dim: Tuple[int, ...] = static_field(default=())
    geom1: Tuple[int, ...] = static_field(default=())
    geom2: Tuple[int, ...] = static_field(default=())


@dataclasses.dataclass
class Data(_Replace):
    """Dynamic state and computed quantities of B environments (mjData);
    every tensor's first dimension is B."""

    time: _T
    qpos: _T
    qvel: _T
    act: _T
    ctrl: _T
    qfrc_applied: _T
    xfrc_applied: _T
    qacc_warmstart: _T
    xpos: _T
    xquat: _T
    xmat: _T
    xipos: _T
    ximat: _T
    geom_xpos: _T
    geom_xmat: _T
    site_xpos: _T
    site_xmat: _T
    subtree_com: _T
    jnt_xanchor: _T
    jnt_xaxis: _T
    cdof: _T
    cinert: _T
    qM: _T
    qLD: _T
    cvel: _T
    cdof_dot: _T
    qfrc_bias: _T
    qfrc_passive: _T
    actuator_length: _T
    actuator_moment: _T
    actuator_velocity: _T
    actuator_force: _T
    act_dot: _T
    qfrc_actuator: _T
    ten_length: _T
    ten_moment: _T
    ten_velocity: _T
    contact: Optional[Contact]
    contact_force: _T
    contact_force_vec: _T
    qfrc_constraint: _T
    qfrc_smooth: _T
    qacc_smooth: _T
    qacc: _T
    sensordata: _T
    energy: _T
    solver_niter: _T


def make_data(m: Model, batch: int, dtype: Optional[torch.dtype] = None
              ) -> Data:
    """Zero-initialized Data for ``batch`` environments with qpos = qpos0
    (mj_makeData).  ``qLD`` is allocated for layout parity only: the port
    never factors qM separately (see ``inertia.solve_m``)."""
    dtype = dtype or m.dtype
    dev = m.device
    B = batch

    def z(*shape):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    def eye3(n):
        return torch.eye(3, dtype=dtype, device=dev).expand(B, n, 3, 3) \
            .clone()

    from dm_control_torch.physics import collision  # circular-safe: lazy

    contact = collision.empty_contact(m, B, dtype)
    ncon = len(contact.dim)
    xquat = z(m.nbody, 4)
    xquat[..., 0] = 1.0
    return Data(
        time=z(),
        qpos=m.qpos0.to(dtype).expand(B, m.nq).clone(),
        qvel=z(m.nv), act=z(m.na), ctrl=z(m.nu), qfrc_applied=z(m.nv),
        xfrc_applied=z(m.nbody, 6), qacc_warmstart=z(m.nv),
        xpos=z(m.nbody, 3), xquat=xquat, xmat=eye3(m.nbody),
        xipos=z(m.nbody, 3), ximat=eye3(m.nbody),
        geom_xpos=z(m.ngeom, 3), geom_xmat=eye3(m.ngeom),
        site_xpos=z(m.nsite, 3), site_xmat=eye3(m.nsite),
        subtree_com=z(m.nbody, 3), jnt_xanchor=z(m.njnt, 3),
        jnt_xaxis=z(m.njnt, 3), cdof=z(m.nv, 6), cinert=z(m.nbody, 10),
        qM=z(m.nv, m.nv), qLD=z(m.nv, m.nv), cvel=z(m.nbody, 6),
        cdof_dot=z(m.nv, 6), qfrc_bias=z(m.nv), qfrc_passive=z(m.nv),
        actuator_length=z(m.nu), actuator_moment=z(m.nu, m.nv),
        actuator_velocity=z(m.nu), actuator_force=z(m.nu), act_dot=z(m.na),
        qfrc_actuator=z(m.nv), ten_length=z(m.ntendon),
        ten_moment=z(m.ntendon, m.nv), ten_velocity=z(m.ntendon),
        contact=contact, contact_force=z(ncon), contact_force_vec=z(ncon, 6),
        qfrc_constraint=z(m.nv), qfrc_smooth=z(m.nv), qacc_smooth=z(m.nv),
        qacc=z(m.nv), sensordata=z(m.nsensordata), energy=z(2),
        solver_niter=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def map_tensors(d: Data, fn) -> Data:
    """A Data with ``fn`` applied to every tensor of ``d`` (the contacts'
    too)."""
    def one(obj):
        return dataclasses.replace(obj, **{
            f.name: (fn(v) if isinstance(v, torch.Tensor)
                     else one(v) if isinstance(v, Contact) else v)
            for f in dataclasses.fields(obj)
            for v in (getattr(obj, f.name),)})
    return one(d)


def env_view(d: Data, i: int = 0) -> Data:
    """Environment ``i`` of a batched Data without its batch axis: every
    tensor a view into ``d``'s, no copy."""
    return map_tensors(d, lambda v: v[i])


# ---------------------------------------------------------------------------
# Static tree masks: subtree and ancestor sums become one masked matmul.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tree_masks_np(parentid: Tuple[int, ...]):
    """(ancestor, subtree) 0/1 masks: ancestor[i, j] = 1 iff j is an
    ancestor-or-self of i; subtree = ancestor.T."""
    n = len(parentid)
    anc = np.zeros((n, n))
    for i in range(n):
        k = i
        while True:
            anc[i, k] = 1.0
            if k == 0:
                break
            k = parentid[k]
    return anc, anc.T


def body_ancestor_mask(m: Model) -> torch.Tensor:
    return m.const("body_ancestor_mask",
                   _tree_masks_np(tuple(m.body_parentid))[0])


def body_subtree_mask(m: Model) -> torch.Tensor:
    return m.const("body_subtree_mask",
                   _tree_masks_np(tuple(m.body_parentid))[1])


def body_dof_mask(m: Model) -> torch.Tensor:
    """(nbody, nv) 0/1: mask[b, v] = 1 iff dof v belongs to body b."""
    mask = np.zeros((m.nbody, m.nv))
    for v, b in enumerate(m.dof_bodyid):
        mask[b, v] = 1.0
    return m.const("body_dof_mask", mask)


@functools.lru_cache(maxsize=None)
def _dof_before_mask_np(parentid, body_jntadr, body_jntnum, jnt_type,
                        jnt_dofadr, nv):
    """(before, rotflag) for cdof_dot (mj_comVel order): before[k, j] = 1
    iff dof j's velocity is already applied when cdof_dot[k] is evaluated;
    rotflag[k] = 0 for a free joint's translational dofs."""
    nbody = len(parentid)
    before = np.zeros((nv, nv))
    rotflag = np.ones((nv,))
    chain: list = [[] for _ in range(nbody)]
    for b in range(1, nbody):
        applied = list(chain[parentid[b]])
        for j in range(body_jntadr[b], body_jntadr[b] + body_jntnum[b]):
            dadr = jnt_dofadr[j]
            jt = jnt_type[j]
            if jt == int(JointType.FREE):
                for k in range(3):
                    rotflag[dadr + k] = 0.0
                applied += [dadr, dadr + 1, dadr + 2]
                for k in range(3, 6):
                    before[dadr + k, applied] = 1.0
                applied += [dadr + 3, dadr + 4, dadr + 5]
            elif jt == int(JointType.BALL):
                for k in range(3):
                    before[dadr + k, applied] = 1.0
                applied += [dadr, dadr + 1, dadr + 2]
            else:
                before[dadr, applied] = 1.0
                applied.append(dadr)
        chain[b] = applied
    return before, rotflag


def dof_before_mask(m: Model) -> Tuple[torch.Tensor, torch.Tensor]:
    before, rotflag = _dof_before_mask_np(
        tuple(m.body_parentid), tuple(m.body_jntadr), tuple(m.body_jntnum),
        tuple(m.jnt_type), tuple(m.jnt_dofadr), m.nv)
    return (m.const("dof_before", before), m.const("dof_rotflag", rotflag))
