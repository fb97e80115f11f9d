"""MJCF element tree → ``physics.Model`` (ahead-of-time compiler).

The port's copy of ``dm_control_tpu/mjcf/compiler.py``.  Everything up to
the assembly of the ``Model`` is the JAX package's numpy float64 code, in
the same order of operations, so every field it writes equals the JAX
compiler's bit for bit.  The leaves become float64 tensors on the host,
``engine.set_const`` fills in the constants that need the physics
(invweights, meaninertia, tendon rest lengths, camera offsets) there, as
the JAX package pins its compile to the host, and only then is the model
moved to its device with its floating leaves cast to the dtype asked for.

This replaces the native MuJoCo model compiler (mj_loadXML/mj_compile,
reached by the reference through dm_control/mujoco/wrapper/core.py:331)
with a host-side numpy pass.  Semantics follow the MJCF modeling
language: default-class resolution, frame orientation attributes,
density-based geom inertia, actuator shortcuts, etc.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from dm_control_torch.mjcf.element import Element
from dm_control_torch.physics.model import (
    BiasType, DynType, EqType, GainType, GeomType, JointType, Model,
    NameMap, ObjType, Option, SensorType, Statistic, TrnType, WrapType,
    DisableBit,
)

_MINVAL = 1e-15

# ---------------------------------------------------------------------------
# Attribute parsing.
# ---------------------------------------------------------------------------


def _floats(v, n=None, pad=0.0) -> Optional[np.ndarray]:
    """Parses a float-array attribute; pads/truncates to n if given."""
    if v is None:
        return None
    if isinstance(v, str):
        arr = np.array([float(x) for x in v.split()], dtype=np.float64)
    elif isinstance(v, (int, float)):
        arr = np.array([float(v)], dtype=np.float64)
    else:
        arr = np.asarray(v, dtype=np.float64).ravel()
    if n is not None:
        if arr.size < n:
            arr = np.concatenate([arr, np.full(n - arr.size, pad)])
        arr = arr[:n]
    return arr


def _float(v, default=None) -> Optional[float]:
    if v is None:
        return default
    return float(v)


def _int(v, default=None) -> Optional[int]:
    if v is None:
        return default
    return int(v)


def _bool(v, default=None) -> Optional[bool]:
    if v is None:
        return default
    if isinstance(v, bool):
        return v
    return {"true": True, "false": False, "1": True, "0": False}[str(v).lower()]


def _kw(v, table: Dict[str, int], default=None) -> Optional[int]:
    if v is None:
        return default
    if isinstance(v, int):
        return v
    return table[str(v).lower()]



_DEF_SOLREF = np.array([0.02, 1.0])
_DEF_SOLIMP = np.array([0.9, 0.95, 0.001, 0.5, 2.0])


def _solpad(v, default) -> np.ndarray:
    """Parses a solref/solimp attribute, padding missing trailing entries
    with the MuJoCo defaults (partial specs like solimplimit="0 .99 .01"
    keep default midpoint/power)."""
    if v is None:
        return default.copy()
    raw = _floats(v)
    out = default.copy()
    out[: min(raw.size, out.size)] = raw[: out.size]
    return out


def _springlength(v) -> np.ndarray:
    """Tendon springlength → (low, high).  A scalar spec replicates into
    both entries (mujoco 3.x oracle semantics, docs/MUJOCO_SEMANTICS.md
    #3); absent/negative values mean "resolve to reference length at
    qpos0" downstream."""
    if v is None:
        return np.array([-1.0, -1.0])
    raw = _floats(v)
    if raw.size == 1:
        return np.array([raw[0], raw[0]])
    return raw[:2].astype(float)


class _Compiler:
    """One-shot compiler state."""

    def __init__(self, root: Element):
        if root.tag != "mujoco":
            raise ValueError(f"Root element must be <mujoco>, got <{root.tag}>")
        self.root = root
        self.model_name = root.get("model", "MuJoCo Model")

        # compiler settings
        comp = root.first("compiler") or Element("compiler")
        self.angle_deg = (comp.get("angle", "degree") == "degree")
        self.eulerseq = comp.get("eulerseq", "xyz")
        self.settotalmass = _float(comp.get("settotalmass"), -1.0)
        self.autolimits = _bool(comp.get("autolimits"), False)
        self.boundmass = _float(comp.get("boundmass"), 0.0)
        self.boundinertia = _float(comp.get("boundinertia"), 0.0)

        # defaults tree: class name -> {elemtag -> merged attrib dict}
        self.defaults: Dict[str, Dict[str, Dict[str, object]]] = {}
        self._build_defaults()

        # output accumulators
        self.bodies: List[dict] = []
        self.joints: List[dict] = []
        self.dofs: List[dict] = []
        self.geoms: List[dict] = []
        self.sites: List[dict] = []
        self.cams: List[dict] = []
        self.tendons: List[dict] = []
        self.wraps: List[dict] = []
        self.actuators: List[dict] = []
        self.sensors: List[dict] = []
        self.equalities: List[dict] = []
        self.excludes: List[tuple] = []
        self.hfields: List[dict] = []
        self.meshes: List[object] = []
        self.mesh_ids: Dict[str, int] = {}
        self._parse_assets()

    def _parse_assets(self):
        asset = self.root.first("asset")
        if asset is None:
            return
        for a in asset.children:
            if a.tag == "hfield":
                self.hfields.append(dict(
                    name=a.get("name", f"hfield{len(self.hfields)}"),
                    nrow=_int(a.get("nrow"), 0),
                    ncol=_int(a.get("ncol"), 0),
                    size=_floats(a.get("size"), 4),
                ))
            elif a.tag == "mesh":
                self._parse_mesh_asset(a)
            # textures/materials: not needed by the physics engine

    def _parse_mesh_asset(self, a: Element):
        """Compiles one <asset><mesh>: STL payload or inline vertex list →
        a centered, principal-axis-aligned MeshAsset (mjcf/mesh.py; the
        analogue of MuJoCo's native mesh compiler, reached by the
        reference through mj_loadXML)."""
        from dm_control_torch.mjcf import mesh as mesh_mod

        scale = _floats(a.get("scale"), 3, pad=1.0)
        vertex = _floats(a.get("vertex"))
        fname = a.get("file")
        name = a.get("name")
        if name is None and fname is not None:
            name = str(fname).rsplit("/", 1)[-1].rsplit(".", 1)[0]
        if name is None:
            name = f"mesh{len(self.meshes)}"
        if vertex is not None:
            verts = np.asarray(vertex, np.float64).reshape(-1, 3)
            faces = None  # hull of the point cloud (MuJoCo semantics)
        else:
            payload = getattr(a, "payload", None)
            if payload is None and fname is not None:
                f = a.attrib.get("file")
                contents = getattr(f, "contents", None)
                if contents is not None:  # attribute.Asset payload
                    payload = contents
            if payload is None:
                raise ValueError(
                    f"mesh asset {name!r}: no vertex data — pass the STL "
                    f"bytes in the parser's assets dict or inline "
                    f"vertex=...")
            verts, faces = mesh_mod.parse_stl(bytes(payload))
        if faces is None:
            from scipy.spatial import ConvexHull

            hull = ConvexHull(verts)
            faces = hull.simplices.astype(np.int32)
            center = verts[np.unique(faces)].mean(0)
            aa, bb, cc = (verts[faces[:, 0]] - center,
                          verts[faces[:, 1]] - center,
                          verts[faces[:, 2]] - center)
            flip = np.einsum("ij,ij->i", aa, np.cross(bb, cc)) < 0
            faces[flip] = faces[flip][:, [0, 2, 1]]
        compiled = mesh_mod.MeshAsset(name, verts, faces, scale=scale)
        self.mesh_ids[name] = len(self.meshes)
        self.meshes.append(compiled)

    # -- angles / orientations ---------------------------------------------

    def _ang(self, x):
        """degrees → radians when compiler angle='degree'."""
        if x is None:
            return None
        x = np.asarray(x, dtype=np.float64)
        return np.deg2rad(x) if self.angle_deg else x

    def _orientation(self, attrs: Dict[str, object]) -> np.ndarray:
        """Resolves quat/euler/axisangle/xyaxes/zaxis → unit quaternion."""
        quat = _floats(attrs.get("quat"), 4)
        if quat is not None:
            n = np.linalg.norm(quat)
            return quat / (n if n > _MINVAL else 1.0)
        euler = _floats(attrs.get("euler"), 3)
        if euler is not None:
            return _euler_to_quat(self._ang(euler), self.eulerseq)
        aa = _floats(attrs.get("axisangle"), 4)
        if aa is not None:
            axis = aa[:3] / max(np.linalg.norm(aa[:3]), _MINVAL)
            return _axis_angle_quat(axis, float(self._ang(aa[3])))
        xyaxes = _floats(attrs.get("xyaxes"), 6)
        if xyaxes is not None:
            x = xyaxes[:3] / max(np.linalg.norm(xyaxes[:3]), _MINVAL)
            y = xyaxes[3:]
            y = y - x * (x @ y)
            y /= max(np.linalg.norm(y), _MINVAL)
            z = np.cross(x, y)
            return _mat_to_quat(np.stack([x, y, z], axis=1))
        zaxis = _floats(attrs.get("zaxis"), 3)
        if zaxis is not None:
            return _z_to_quat(zaxis)
        return np.array([1.0, 0, 0, 0])

    # -- defaults -----------------------------------------------------------

    def _build_defaults(self):
        def walk(delem: Element, inherited: Dict[str, Dict[str, object]]):
            cls = delem.get("class", "main")
            merged = {tag: dict(d) for tag, d in inherited.items()}
            for child in delem.children:
                if child.tag == "default":
                    continue
                merged.setdefault(child.tag, {})
                merged[child.tag].update(
                    {k: v for k, v in child.attrib.items() if k != "class"}
                )
            self.defaults[cls] = merged
            for child in delem.children:
                if child.tag == "default":
                    walk(child, merged)

        top = self.root.first("default")
        if top is not None and top.get("class") is None:
            top.attrib["class"] = "main"
        if top is not None:
            walk(top, {})
        self.defaults.setdefault("main", {})

    def _resolve(self, elem: Element, cls: Optional[str],
                 tag: Optional[str] = None) -> Dict[str, object]:
        """Effective attributes = defaults[class][tag] overlaid by explicit."""
        tag = tag or elem.tag
        cls = elem.get("class") or cls or "main"
        base = dict(self.defaults.get(cls, self.defaults["main"]).get(tag, {}))
        base.update(elem.attrib)
        return base

    # -- main compile -------------------------------------------------------

    def compile(self) -> Model:
        self._compile_options()
        world = self.root.first("worldbody")
        if world is None:
            raise ValueError("Model has no <worldbody>.")
        # body 0 = world
        self.bodies.append(dict(
            name="world", parentid=0, pos=np.zeros(3), quat=np.array([1.0, 0, 0, 0]),
            explicit_inertial=False, mass=0.0, ipos=np.zeros(3),
            iquat=np.array([1.0, 0, 0, 0]), inertia=np.zeros(3),
            jntadr=-1, jntnum=0, dofadr=-1, dofnum=0, geomadr=0, geomnum=0,
            world_pos=np.zeros(3), world_quat=np.array([1.0, 0, 0, 0]),
            static_chain=True,
        ))
        self._compile_body_children(world, 0, None)
        self._finalize_bodies()
        self._compile_tendons()
        self._compile_actuators()
        self._compile_sensors()
        self._compile_equality()
        self._compile_contact()
        return self._build_model()

    def _compile_options(self):
        # MJCF allows repeated <option> sections (merged by MuJoCo)
        opt_el = Element("option")
        flag_el = Element("flag")
        for child in self.root.children:
            if child.tag != "option":
                continue
            opt_el.attrib.update(child.attrib)
            for sub in child.children:
                if sub.tag == "flag":
                    flag_el.attrib.update(sub.attrib)
        self.opt_timestep = _float(opt_el.get("timestep"), 0.002)
        self.opt_gravity = _floats(opt_el.get("gravity"), 3)
        if self.opt_gravity is None:
            self.opt_gravity = np.array([0.0, 0, -9.81])
        self.opt_wind = _floats(opt_el.get("wind"), 3)
        if self.opt_wind is None:
            self.opt_wind = np.zeros(3)
        self.opt_magnetic = _floats(opt_el.get("magnetic"), 3)
        if self.opt_magnetic is None:
            self.opt_magnetic = np.array([0.0, -0.5, 0.0])
        self.opt_density = _float(opt_el.get("density"), 0.0)
        self.opt_viscosity = _float(opt_el.get("viscosity"), 0.0)
        self.opt_impratio = _float(opt_el.get("impratio"), 1.0)
        self.opt_tolerance = _float(opt_el.get("tolerance"), 1e-8)
        self.opt_integrator = _kw(opt_el.get("integrator"), {
            "euler": 0, "rk4": 1, "implicit": 2, "implicitfast": 3}, 0)
        self.opt_cone = _kw(opt_el.get("cone"), {"pyramidal": 0, "elliptic": 1}, 0)
        self.opt_solver = _kw(opt_el.get("solver"), {"pgs": 0, "cg": 1, "newton": 2}, 2)
        self.opt_iterations = _int(opt_el.get("iterations"), 100)
        self.opt_ls_iterations = _int(opt_el.get("ls_iterations"), 50)
        self.opt_noslip = _int(opt_el.get("noslip_iterations"), 0)
        self.opt_o_margin = _float(opt_el.get("o_margin"), 0.0)

        disable = 0
        for attr, bit in [
            ("constraint", DisableBit.CONSTRAINT), ("equality", DisableBit.EQUALITY),
            ("frictionloss", DisableBit.FRICTIONLOSS), ("limit", DisableBit.LIMIT),
            ("contact", DisableBit.CONTACT), ("passive", DisableBit.PASSIVE),
            ("gravity", DisableBit.GRAVITY), ("clampctrl", DisableBit.CLAMPCTRL),
            ("warmstart", DisableBit.WARMSTART),
            ("filterparent", DisableBit.FILTERPARENT),
            ("actuation", DisableBit.ACTUATION), ("refsafe", DisableBit.REFSAFE),
        ]:
            if flag_el.get(attr) == "disable":
                disable |= int(bit)
        self.opt_disableflags = disable
        self.flag_energy = flag_el.get("energy") == "enable"

    # -- body tree ----------------------------------------------------------

    def _compile_body_children(self, elem: Element, bodyid: int,
                               childclass: Optional[str]):
        body = self.bodies[bodyid]
        for child in elem.children:
            if child.tag == "body":
                self._compile_body(child, bodyid, childclass)
            elif child.tag in ("joint", "freejoint"):
                self._compile_joint(child, bodyid, childclass)
            elif child.tag == "geom":
                self._compile_geom(child, bodyid, childclass)
            elif child.tag == "site":
                self._compile_site(child, bodyid, childclass)
            elif child.tag == "camera":
                self._compile_camera(child, bodyid, childclass)
            elif child.tag == "inertial":
                self._compile_inertial(child, bodyid)
            elif child.tag == "light":
                pass  # rendering is off-path
            else:
                raise ValueError(
                    f"Unsupported element <{child.tag}> in body "
                    f"{body['name']!r}.")

    def _compile_body(self, elem: Element, parentid: int,
                      childclass: Optional[str]):
        parent = self.bodies[parentid]
        cc = elem.get("childclass") or childclass
        attrs = dict(elem.attrib)
        pos = _floats(attrs.get("pos"), 3)
        pos = pos if pos is not None else np.zeros(3)
        quat = self._orientation(attrs)
        bodyid = len(self.bodies)
        # world frame in default configuration (valid while chain is static)
        wq = _quat_mul(parent["world_quat"], quat)
        wp = parent["world_pos"] + _quat_rot(parent["world_quat"], pos)
        self.bodies.append(dict(
            name=attrs.get("name", f"body{bodyid}"),
            parentid=parentid, pos=pos, quat=quat,
            explicit_inertial=False, mass=0.0, ipos=np.zeros(3),
            iquat=np.array([1.0, 0, 0, 0]), inertia=np.zeros(3),
            jntadr=-1, jntnum=0, dofadr=-1, dofnum=0, geomadr=-1, geomnum=0,
            world_pos=wp, world_quat=wq, static_chain=parent["static_chain"],
        ))
        self._compile_body_children(elem, bodyid, cc)

    def _compile_inertial(self, elem: Element, bodyid: int):
        body = self.bodies[bodyid]
        attrs = self._resolve(elem, None)
        body["explicit_inertial"] = True
        body["mass"] = _float(attrs.get("mass"), 0.0)
        pos = _floats(attrs.get("pos"), 3)
        body["ipos"] = pos if pos is not None else np.zeros(3)
        body["iquat"] = self._orientation(attrs)
        diag = _floats(attrs.get("diaginertia"), 3)
        if diag is not None:
            body["inertia"] = diag
        else:
            full = _floats(attrs.get("fullinertia"), 6)
            if full is not None:
                mat = np.array([
                    [full[0], full[3], full[4]],
                    [full[3], full[1], full[5]],
                    [full[4], full[5], full[2]],
                ])
                vals, vecs = _principal(mat)
                body["inertia"] = vals
                body["iquat"] = _quat_mul(body["iquat"], _mat_to_quat(vecs))

    def _compile_joint(self, elem: Element, bodyid: int,
                       childclass: Optional[str]):
        body = self.bodies[bodyid]
        body["static_chain"] = False
        if elem.tag == "freejoint":
            attrs = {"type": "free", "name": elem.get("name")}
        else:
            attrs = self._resolve(elem, childclass, "joint")
        jtype = JointType({"free": 0, "ball": 1, "slide": 2, "hinge": 3}[
            str(attrs.get("type", "hinge"))])
        if jtype == JointType.FREE and not body["static_chain"]:
            pass  # checked in finalize (ancestors must be static)
        axis = _floats(attrs.get("axis"), 3)
        axis = axis if axis is not None else np.array([0.0, 0, 1.0])
        axis = axis / max(np.linalg.norm(axis), _MINVAL)
        rng = _floats(attrs.get("range"), 2)
        has_range = rng is not None and not np.all(rng == 0)
        limited = _bool(attrs.get("limited"),
                        has_range if self.autolimits else False)
        rng = rng if rng is not None else np.zeros(2)
        if jtype in (JointType.HINGE, JointType.BALL):
            rng = self._ang(rng)
        ref = _float(attrs.get("ref"), 0.0)
        springref = _float(attrs.get("springref"), 0.0)
        if jtype == JointType.HINGE:
            ref = float(self._ang(ref))
            springref = float(self._ang(springref))
        jid = len(self.joints)
        if body["jntadr"] < 0:
            body["jntadr"] = jid
        body["jntnum"] += 1
        pos = _floats(attrs.get("pos"), 3)
        self.joints.append(dict(
            name=attrs.get("name", f"joint{jid}"),
            type=jtype, bodyid=bodyid, axis=axis,
            pos=pos if pos is not None else np.zeros(3),
            limited=bool(limited), range=rng,
            margin=float(self._ang(_float(attrs.get("margin"), 0.0))
                         if jtype in (JointType.HINGE, JointType.BALL)
                         else _float(attrs.get("margin"), 0.0)),
            ref=ref, springref=springref,
            stiffness=_float(attrs.get("stiffness"), 0.0),
            springdamper=tuple(_floats(attrs.get("springdamper"), 2)
                               if attrs.get("springdamper") else (0.0, 0.0)),
            damping=_float(attrs.get("damping"), 0.0),
            armature=_float(attrs.get("armature"), 0.0),
            frictionloss=_float(attrs.get("frictionloss"), 0.0),
            solref=_solpad(attrs.get("solreflimit"), _DEF_SOLREF),
            solimp=_solpad(attrs.get("solimplimit"), _DEF_SOLIMP),
            solref_fri=_solpad(attrs.get("solreffriction"), _DEF_SOLREF),
            solimp_fri=_solpad(attrs.get("solimpfriction"), _DEF_SOLIMP),
        ))

    _GEOM_TYPES = {"plane": 0, "hfield": 1, "sphere": 2, "capsule": 3,
                   "ellipsoid": 4, "cylinder": 5, "box": 6, "mesh": 7}

    def _compile_geom(self, elem: Element, bodyid: int,
                      childclass: Optional[str]):
        body = self.bodies[bodyid]
        attrs = self._resolve(elem, childclass, "geom")
        gtype = GeomType(self._GEOM_TYPES[str(attrs.get("type", "sphere"))])
        size = _floats(attrs.get("size"), 3, pad=0.0)
        if size is None:
            size = np.zeros(3)
        pos = _floats(attrs.get("pos"), 3)
        pos = pos if pos is not None else np.zeros(3)
        quat = self._orientation(attrs)
        meshid = -1
        if gtype == GeomType.MESH:
            meshname = attrs.get("mesh")
            if meshname is None or str(meshname) not in self.mesh_ids:
                raise ValueError(
                    f"geom {attrs.get('name', elem.path)!r}: type='mesh' "
                    f"needs a mesh= reference to a compiled <asset><mesh> "
                    f"(have: {sorted(self.mesh_ids)})")
            meshid = self.mesh_ids[str(meshname)]
            mesh = self.meshes[meshid]
            # compose the geom frame with the mesh's baked centering/
            # principal-axis transform (MuJoCo stores the same transform
            # in mjModel.mesh_pos/mesh_quat and pre-multiplies it here)
            pos = pos + _quat_rot(quat, mesh.pos)
            quat = _quat_mul(quat, mesh.quat)
            # size: AABB half-extents in the (centered) geom frame
            size = np.abs(mesh.verts).max(axis=0)
        fromto = _floats(attrs.get("fromto"), 6)
        if fromto is not None:
            f, t = fromto[:3], fromto[3:]
            pos = 0.5 * (f + t)
            # MuJoCo orients the frame z-axis along (from - to): verified
            # against mjModel.geom_quat for all axis directions (the
            # dynamics are symmetric, but xmat-based observations such as
            # fish's mouth frame depend on the sign)
            quat = _z_to_quat(f - t)
            half = 0.5 * np.linalg.norm(t - f)
            if gtype in (GeomType.CAPSULE, GeomType.CYLINDER):
                size = np.array([size[0], half, 0.0])
            elif gtype in (GeomType.BOX, GeomType.ELLIPSOID):
                size = np.array([size[0], size[1], half])
        gid = len(self.geoms)
        if body["geomadr"] < 0:
            body["geomadr"] = gid
        body["geomnum"] += 1
        mass = _float(attrs.get("mass"))
        density = _float(attrs.get("density"), 1000.0)
        friction = _floats(attrs.get("friction"), 3)
        if friction is None:
            friction = np.array([1.0, 0.005, 0.0001])
        else:
            # partial friction spec keeps defaults for missing entries
            raw = _floats(attrs.get("friction"))
            dflt = np.array([1.0, 0.005, 0.0001])
            friction = np.concatenate([raw, dflt[raw.size:]])[:3]
        self.geoms.append(dict(
            name=attrs.get("name", f"geom{gid}"),
            type=gtype, bodyid=bodyid, size=size, pos=pos, quat=quat,
            contype=_int(attrs.get("contype"), 1),
            conaffinity=_int(attrs.get("conaffinity"), 1),
            condim=_int(attrs.get("condim"), 3),
            priority=_int(attrs.get("priority"), 0),
            friction=friction,
            solmix=_float(attrs.get("solmix"), 1.0),
            solref=_solpad(attrs.get("solref"), _DEF_SOLREF),
            solimp=_solpad(attrs.get("solimp"), _DEF_SOLIMP),
            margin=_float(attrs.get("margin"), 0.0),
            gap=_float(attrs.get("gap"), 0.0),
            mass=mass, density=density,
            rgba=_floats(attrs.get("rgba"), 4) if attrs.get("rgba") is not None else np.array([0.5, 0.5, 0.5, 1.0]),
            group=_int(attrs.get("group"), 0),
            hfieldname=attrs.get("hfield"),
            meshid=meshid,
        ))

    _SITE_TYPES = {"sphere": 2, "capsule": 3, "ellipsoid": 4, "cylinder": 5,
                   "box": 6}

    def _compile_site(self, elem: Element, bodyid: int,
                      childclass: Optional[str]):
        body = self.bodies[bodyid]
        attrs = self._resolve(elem, childclass, "site")
        pos = _floats(attrs.get("pos"), 3)
        pos = pos if pos is not None else np.zeros(3)
        quat = self._orientation(attrs)
        size = _floats(attrs.get("size"), 3, pad=0.0)
        if size is None:
            size = np.array([0.005, 0.005, 0.005])
        elif np.all(size[1:] == 0):
            size = np.array([size[0]] * 3) if size[0] > 0 else np.array([0.005] * 3)
        fromto = _floats(attrs.get("fromto"), 6)
        if fromto is not None:
            f, t = fromto[:3], fromto[3:]
            pos = 0.5 * (f + t)
            quat = _z_to_quat(f - t)  # matches geom fromto convention
        sid = len(self.sites)
        self.sites.append(dict(
            name=attrs.get("name", f"site{sid}"),
            type=self._SITE_TYPES[str(attrs.get("type", "sphere"))],
            bodyid=bodyid, pos=pos, quat=quat, size=size,
        ))

    _CAM_MODES = {"fixed": 0, "track": 1, "trackcom": 2,
                  "targetbody": 3, "targetbodycom": 4}

    def _compile_camera(self, elem: Element, bodyid: int,
                        childclass: Optional[str]):
        attrs = self._resolve(elem, childclass, "camera")
        pos = _floats(attrs.get("pos"), 3)
        self.cams.append(dict(
            name=attrs.get("name", f"cam{len(self.cams)}"),
            bodyid=bodyid,
            pos=pos if pos is not None else np.zeros(3),
            quat=self._orientation(attrs),
            fovy=_float(attrs.get("fovy"), 45.0),
            mode=self._CAM_MODES[str(attrs.get("mode", "fixed"))],
            target=str(attrs.get("target", "")),
        ))

    # -- inertia from geoms -------------------------------------------------

    def _finalize_bodies(self):
        # mjModel stores joints/geoms/sites/cameras contiguously per body;
        # document order can interleave (e.g. a parent's <joint> declared
        # after a child <body>), so stable-sort by bodyid and rebuild
        # addresses.  Joint order determines qpos/dof layout: parent dofs
        # must precede descendants' (tree order).
        for kind in ("joints", "geoms", "sites", "cams"):
            items = getattr(self, kind)
            items.sort(key=lambda it: it["bodyid"])
        for body in self.bodies:
            body["jntadr"], body["jntnum"] = -1, 0
        for jid, j in enumerate(self.joints):
            body = self.bodies[j["bodyid"]]
            if body["jntadr"] < 0:
                body["jntadr"] = jid
            body["jntnum"] += 1
        for body in self.bodies:
            body["geomadr"], body["geomnum"] = -1, 0
        for gid, g in enumerate(self.geoms):
            body = self.bodies[g["bodyid"]]
            if body["geomadr"] < 0:
                body["geomadr"] = gid
            body["geomnum"] += 1

        # geom masses/inertias
        for g in self.geoms:
            if g["type"] == GeomType.MESH and g.get("meshid", -1) >= 0:
                # exact polyhedral mass properties (mjcf/mesh.py); the
                # geom frame IS the mesh's principal frame after the
                # baked composition in _compile_geom
                mesh = self.meshes[g["meshid"]]
                vol, inert_unit = mesh.volume, mesh.inertia_unit_mass
            else:
                vol, inert_unit = _geom_volume_inertia(g["type"], g["size"])
            if g["mass"] is not None:
                m = g["mass"]
            else:
                m = g["density"] * vol
            g["computed_mass"] = m
            # inertia about geom CoM, diagonal in geom frame (unit mass basis)
            g["computed_inertia"] = inert_unit * m

        for bodyid, body in enumerate(self.bodies):
            if bodyid == 0 or body["explicit_inertial"]:
                continue
            gs = [g for g in self.geoms if g["bodyid"] == bodyid]
            total = sum(g["computed_mass"] for g in gs)
            if total <= 0 or not gs:
                body["mass"] = max(0.0, self.boundmass)
                body["inertia"] = np.full(3, max(0.0, self.boundinertia))
                continue
            com = sum(g["computed_mass"] * g["pos"] for g in gs) / total
            imat = np.zeros((3, 3))
            for g in gs:
                rot = _quat_to_mat(g["quat"])
                ig = rot @ np.diag(g["computed_inertia"]) @ rot.T
                r = g["pos"] - com
                imat += ig + g["computed_mass"] * (
                    (r @ r) * np.eye(3) - np.outer(r, r))
            vals, vecs = _principal(imat)
            body["mass"] = total
            body["ipos"] = com
            body["inertia"] = np.maximum(vals, self.boundinertia)
            body["iquat"] = _mat_to_quat(vecs)

        # settotalmass rescaling (mjCModel::SetTotalmass)
        if self.settotalmass > 0:
            total = sum(b["mass"] for b in self.bodies[1:])
            if total > 0:
                scale = self.settotalmass / total
                for b in self.bodies[1:]:
                    b["mass"] *= scale
                    b["inertia"] = b["inertia"] * scale

        # dof layout
        qadr = 0
        dadr = 0
        for j in self.joints:
            j["qposadr"] = qadr
            j["dofadr"] = dadr
            qadr += j["type"].qpos_width
            dadr += j["type"].dof_width
        self.nq = qadr
        self.nv = dadr

        # per-body dof bookkeeping + dof records
        last_dof_of_body: Dict[int, int] = {}
        for j in self.joints:
            b = j["bodyid"]
            body = self.bodies[b]
            if body["dofadr"] < 0:
                body["dofadr"] = j["dofadr"]
            body["dofnum"] += j["type"].dof_width
            for k in range(j["type"].dof_width):
                dofid = j["dofadr"] + k
                if k > 0:
                    parentdof = dofid - 1
                elif b in last_dof_of_body:
                    parentdof = last_dof_of_body[b]
                else:
                    # nearest ancestor body with dofs
                    pb = self.bodies[b]["parentid"]
                    while pb != 0 and pb not in last_dof_of_body:
                        pb = self.bodies[pb]["parentid"]
                    parentdof = last_dof_of_body.get(pb, -1)
                self.dofs.append(dict(
                    bodyid=b, jntid=self.joints.index(j), parentid=parentdof,
                    armature=j["armature"], damping=j["damping"],
                    frictionloss=j["frictionloss"],
                    solref_fri=j["solref_fri"], solimp_fri=j["solimp_fri"],
                ))
            last_dof_of_body[b] = j["dofadr"] + j["type"].dof_width - 1

        # qpos0 / qpos_spring
        qpos0 = np.zeros(self.nq)
        qpos_spring = np.zeros(self.nq)
        for j in self.joints:
            a = j["qposadr"]
            if j["type"] == JointType.FREE:
                body = self.bodies[j["bodyid"]]
                qpos0[a:a + 3] = body["world_pos"]
                qpos0[a + 3:a + 7] = body["world_quat"]
                qpos_spring[a:a + 7] = qpos0[a:a + 7]
            elif j["type"] == JointType.BALL:
                qpos0[a:a + 4] = [1, 0, 0, 0]
                qpos_spring[a:a + 4] = [1, 0, 0, 0]
            else:
                qpos0[a] = j["ref"]
                qpos_spring[a] = j["springref"]
        self.qpos0 = qpos0
        self.qpos_spring = qpos_spring

    # -- tendons ------------------------------------------------------------

    def _compile_tendons(self):
        section = self.root.first("tendon")
        if section is None:
            return
        for t in section.children:
            # Defaults blocks only ever contain <tendon> (never <fixed> /
            # <spatial>): both tendon kinds share that defaults entry.
            attrs = self._resolve(t, None, "tendon")
            adr = len(self.wraps)
            if t.tag == "fixed":
                for w in t.children:
                    wattrs = self._resolve(w, None, "joint" if w.tag == "joint" else w.tag)
                    if w.tag != "joint":
                        raise ValueError("fixed tendon supports <joint> only")
                    self.wraps.append(dict(
                        type=WrapType.JOINT,
                        objname=w.get("joint"),
                        prm=_float(wattrs.get("coef"), 0.0),
                    ))
            elif t.tag == "spatial":
                for w in t.children:
                    if w.tag == "site":
                        self.wraps.append(dict(
                            type=WrapType.SITE, objname=w.get("site"), prm=0.0))
                    elif w.tag == "geom":
                        raise NotImplementedError(
                            "spatial tendon geom wrapping not yet supported")
                    else:
                        raise ValueError(f"bad spatial tendon child <{w.tag}>")
            else:
                raise ValueError(f"unknown tendon type <{t.tag}>")
            rng = _floats(attrs.get("range"), 2)
            has_range = rng is not None and not np.all(rng == 0)
            limited = _bool(attrs.get("limited"),
                            has_range if self.autolimits else False)
            self.tendons.append(dict(
                name=attrs.get("name", f"tendon{len(self.tendons)}"),
                adr=adr, num=len(self.wraps) - adr,
                limited=bool(limited),
                range=rng if rng is not None else np.zeros(2),
                margin=_float(attrs.get("margin"), 0.0),
                stiffness=_float(attrs.get("stiffness"), 0.0),
                damping=_float(attrs.get("damping"), 0.0),
                # scalar springlength replicates into (low, high) — mujoco
                # 3.x oracle semantics (docs/MUJOCO_SEMANTICS.md #3); only
                # negative values mean "use reference length at qpos0"
                springlength=_springlength(attrs.get("springlength")),
                solref=_solpad(attrs.get("solreflimit"), _DEF_SOLREF),
                solimp=_solpad(attrs.get("solimplimit"), _DEF_SOLIMP),
            ))

    # -- actuators ----------------------------------------------------------

    def _compile_actuators(self):
        section = self.root.first("actuator")
        if section is None:
            return
        jnames = {j["name"]: i for i, j in enumerate(self.joints)}
        tnames = {t["name"]: i for i, t in enumerate(self.tendons)}
        snames = {s["name"]: i for i, s in enumerate(self.sites)}
        for a in section.children:
            attrs = self._resolve(a, None, a.tag)
            shortcut = a.tag
            gear = _floats(attrs.get("gear"), 6, pad=0.0)
            if gear is None:
                gear = np.array([1.0, 0, 0, 0, 0, 0])
            dynprm = np.zeros(10); dynprm[0] = 1.0
            gainprm = np.zeros(10); gainprm[0] = 1.0
            biasprm = np.zeros(10)
            dyntype, gaintype, biastype = DynType.NONE, GainType.FIXED, BiasType.NONE
            if shortcut == "motor":
                pass
            elif shortcut == "position":
                kp = _float(attrs.get("kp"), 1.0)
                kv = _float(attrs.get("kv"), 0.0)
                gainprm[0] = kp
                biastype = BiasType.AFFINE
                biasprm[1] = -kp
                biasprm[2] = -kv
            elif shortcut == "velocity":
                kv = _float(attrs.get("kv"), 1.0)
                gainprm[0] = kv
                biastype = BiasType.AFFINE
                biasprm[2] = -kv
            elif shortcut == "general":
                dyntype = DynType(_kw(attrs.get("dyntype"), {
                    "none": 0, "integrator": 1, "filter": 2,
                    "filterexact": 3, "muscle": 4}, 0))
                gaintype = GainType(_kw(attrs.get("gaintype"), {
                    "fixed": 0, "affine": 1, "muscle": 2}, 0))
                biastype = BiasType(_kw(attrs.get("biastype"), {
                    "none": 0, "affine": 1, "muscle": 2}, 0))
                for prm, key in [(dynprm, "dynprm"), (gainprm, "gainprm"),
                                 (biasprm, "biasprm")]:
                    v = _floats(attrs.get(key))
                    if v is not None:
                        prm[:v.size] = v
            else:
                raise ValueError(f"unsupported actuator <{shortcut}>")

            if attrs.get("joint") is not None:
                trntype, trnid = TrnType.JOINT, jnames[attrs["joint"]]
            elif attrs.get("tendon") is not None:
                trntype, trnid = TrnType.TENDON, tnames[attrs["tendon"]]
            elif attrs.get("site") is not None:
                trntype, trnid = TrnType.SITE, snames[attrs["site"]]
            else:
                raise ValueError("actuator needs a transmission target")

            ctrlrange = _floats(attrs.get("ctrlrange"), 2)
            has_cr = ctrlrange is not None and not np.all(ctrlrange == 0)
            ctrllimited = _bool(attrs.get("ctrllimited"),
                                has_cr if self.autolimits else False)
            forcerange = _floats(attrs.get("forcerange"), 2)
            has_fr = forcerange is not None and not np.all(forcerange == 0)
            forcelimited = _bool(attrs.get("forcelimited"),
                                 has_fr if self.autolimits else False)
            self.actuators.append(dict(
                name=attrs.get("name", f"actuator{len(self.actuators)}"),
                trntype=trntype, trnid=trnid, dyntype=dyntype,
                gaintype=gaintype, biastype=biastype,
                dynprm=dynprm, gainprm=gainprm, biasprm=biasprm,
                gear=gear,
                ctrllimited=bool(ctrllimited),
                ctrlrange=ctrlrange if ctrlrange is not None else np.zeros(2),
                forcelimited=bool(forcelimited),
                forcerange=forcerange if forcerange is not None else np.zeros(2),
            ))

    # -- sensors ------------------------------------------------------------

    _SENSOR_TABLE = {
        # tag: (SensorType, objtype kw, dim)
        "touch": (SensorType.TOUCH, "site", 1),
        "accelerometer": (SensorType.ACCELEROMETER, "site", 3),
        "velocimeter": (SensorType.VELOCIMETER, "site", 3),
        "gyro": (SensorType.GYRO, "site", 3),
        "force": (SensorType.FORCE, "site", 3),
        "torque": (SensorType.TORQUE, "site", 3),
        "magnetometer": (SensorType.MAGNETOMETER, "site", 3),
        "rangefinder": (SensorType.RANGEFINDER, "site", 1),
        "jointpos": (SensorType.JOINTPOS, "joint", 1),
        "jointvel": (SensorType.JOINTVEL, "joint", 1),
        "tendonpos": (SensorType.TENDONPOS, "tendon", 1),
        "tendonvel": (SensorType.TENDONVEL, "tendon", 1),
        "actuatorpos": (SensorType.ACTUATORPOS, "actuator", 1),
        "actuatorvel": (SensorType.ACTUATORVEL, "actuator", 1),
        "actuatorfrc": (SensorType.ACTUATORFRC, "actuator", 1),
        "ballquat": (SensorType.BALLQUAT, "joint", 4),
        "ballangvel": (SensorType.BALLANGVEL, "joint", 3),
        "framepos": (SensorType.FRAMEPOS, "frame", 3),
        "framequat": (SensorType.FRAMEQUAT, "frame", 4),
        "framexaxis": (SensorType.FRAMEXAXIS, "frame", 3),
        "frameyaxis": (SensorType.FRAMEYAXIS, "frame", 3),
        "framezaxis": (SensorType.FRAMEZAXIS, "frame", 3),
        "framelinvel": (SensorType.FRAMELINVEL, "frame", 3),
        "frameangvel": (SensorType.FRAMEANGVEL, "frame", 3),
        "framelinacc": (SensorType.FRAMELINACC, "frame", 3),
        "frameangacc": (SensorType.FRAMEANGACC, "frame", 3),
        "subtreecom": (SensorType.SUBTREECOM, "body", 3),
        "subtreelinvel": (SensorType.SUBTREELINVEL, "body", 3),
        "subtreeangmom": (SensorType.SUBTREEANGMOM, "body", 3),
    }

    def _compile_sensors(self):
        section = self.root.first("sensor")
        if section is None:
            return
        names = {
            "site": {s["name"]: i for i, s in enumerate(self.sites)},
            "joint": {j["name"]: i for i, j in enumerate(self.joints)},
            "body": {b["name"]: i for i, b in enumerate(self.bodies)},
            "geom": {g["name"]: i for i, g in enumerate(self.geoms)},
            "tendon": {t["name"]: i for i, t in enumerate(self.tendons)},
            "actuator": {a["name"]: i for i, a in enumerate(self.actuators)},
        }
        objtype_enum = {"site": ObjType.SITE, "joint": ObjType.JOINT,
                        "body": ObjType.BODY, "xbody": ObjType.XBODY,
                        "geom": ObjType.GEOM, "tendon": ObjType.JOINT,
                        "actuator": ObjType.JOINT, "camera": ObjType.CAMERA}
        adr = 0
        for s in section.children:
            if s.tag not in self._SENSOR_TABLE:
                raise ValueError(f"unsupported sensor <{s.tag}>")
            stype, objkind, dim = self._SENSOR_TABLE[s.tag]
            if objkind == "frame":
                objkind = s.get("objtype", "body")
                objname = s.get("objname")
            else:
                objname = s.get(objkind)
            lookup = "body" if objkind == "xbody" else objkind
            objid = names[lookup][objname]
            self.sensors.append(dict(
                name=s.get("name", f"sensor{len(self.sensors)}"),
                type=stype, objtype=objtype_enum[objkind], objid=objid,
                adr=adr, dim=dim,
                cutoff=_float(s.get("cutoff"), 0.0),
            ))
            adr += dim
        self.nsensordata = adr

    # -- equality / contact -------------------------------------------------

    def _compile_equality(self):
        section = self.root.first("equality")
        if section is None:
            return
        bnames = {b["name"]: i for i, b in enumerate(self.bodies)}
        jnames = {j["name"]: i for i, j in enumerate(self.joints)}
        for e in section.children:
            # All equality sub-types (connect/weld/joint/tendon/distance)
            # share the single <equality> defaults entry (MuJoCo schema).
            attrs = self._resolve(e, None, "equality")
            data = np.zeros(11)
            if e.tag == "connect":
                etype = EqType.CONNECT
                obj1 = bnames[attrs["body1"]]
                obj2 = bnames.get(attrs.get("body2", "world"), 0)
                anchor = _floats(attrs.get("anchor"), 3)
                data[:3] = anchor
                # body2-local coordinates of the anchor at model config
                b1w, b2w = self.bodies[obj1], self.bodies[obj2]
                p_world = b1w["world_pos"] + _quat_rot(b1w["world_quat"],
                                                       anchor)
                q2c = np.array([1.0, -1, -1, -1]) * b2w["world_quat"]
                data[3:6] = _quat_rot(q2c, p_world - b2w["world_pos"])
            elif e.tag == "weld":
                etype = EqType.WELD
                obj1 = bnames[attrs["body1"]]
                obj2 = bnames.get(attrs.get("body2", "world"), 0)
                relpose = _floats(attrs.get("relpose"), 7)
                if relpose is None:
                    data[3:10] = [0, 0, 0, 1, 0, 0, 0]  # computed at init
                    data[10] = 1.0  # torquescale
                else:
                    data[3:10] = relpose
            elif e.tag == "joint":
                etype = EqType.JOINT
                obj1 = jnames[attrs["joint1"]]
                obj2 = jnames.get(attrs.get("joint2", ""), -1) \
                    if attrs.get("joint2") else -1
                poly = _floats(attrs.get("polycoef"), 5)
                if poly is None:
                    poly = np.array([0.0, 1, 0, 0, 0])
                data[:5] = poly
            elif e.tag == "tendon":
                etype = EqType.TENDON
                tnames = {t["name"]: i for i, t in enumerate(self.tendons)}
                obj1 = tnames[attrs["tendon1"]]
                obj2 = tnames.get(attrs.get("tendon2", ""), -1) \
                    if attrs.get("tendon2") else -1
                poly = _floats(attrs.get("polycoef"), 5)
                if poly is None:
                    poly = np.array([0.0, 1, 0, 0, 0])
                data[:5] = poly
            else:
                raise ValueError(f"unsupported equality <{e.tag}>")
            self.equalities.append(dict(
                name=attrs.get("name", f"eq{len(self.equalities)}"),
                type=etype, obj1id=obj1, obj2id=obj2,
                active=_bool(attrs.get("active"), True),
                solref=_solpad(attrs.get("solref"), _DEF_SOLREF),
                solimp=_solpad(attrs.get("solimp"), _DEF_SOLIMP),
                data=data,
            ))

    def _compile_contact(self):
        section = self.root.first("contact")
        if section is None:
            return
        bnames = {b["name"]: i for i, b in enumerate(self.bodies)}
        for e in section.children:
            if e.tag == "exclude":
                self.excludes.append((bnames[e.get("body1")],
                                      bnames[e.get("body2")]))
            elif e.tag == "pair":
                raise NotImplementedError("<contact><pair> not yet supported")

    # -- assembly -----------------------------------------------------------

    def _collision_pairs(self):
        """Static broadphase: candidate geom pairs after all static filters.

        Mirrors mj_collision's filtering (same-body, weld, parent-child via
        mjDSBL_FILTERPARENT, contype/conaffinity bitmasks, <exclude>),
        plus a compile-time reachability sweep (``_pair_reachable``): a
        pair whose geoms provably can never touch under any joint
        configuration gets no contact rows at all — the static-shape
        analogue of the per-step broadphase culling native mj_step does
        (dm_control/mujoco/engine.py:161-166).
        """
        nb = len(self.bodies)
        parent = [b["parentid"] for b in self.bodies]
        weld = [0] * nb
        for i in range(1, nb):
            weld[i] = i if self.bodies[i]["dofnum"] > 0 else weld[parent[i]]
        filterparent = not (self.opt_disableflags & DisableBit.FILTERPARENT)
        excl = {tuple(sorted(p)) for p in self.excludes}
        pairs = []
        ng = len(self.geoms)
        ball_cache = {}
        for i in range(ng):
            for k in range(i + 1, ng):
                g1, g2 = self.geoms[i], self.geoms[k]
                b1, b2 = g1["bodyid"], g2["bodyid"]
                if b1 == b2:
                    continue
                w1, w2 = weld[b1], weld[b2]
                if w1 == w2:
                    continue
                if filterparent and w1 != 0 and w2 != 0 and (
                        weld[parent[w1]] == w2 or weld[parent[w2]] == w1):
                    continue
                if tuple(sorted((b1, b2))) in excl:
                    continue
                t1, t2 = int(g1["type"]), int(g2["type"])
                if not ((g1["contype"] & g2["conaffinity"]) or
                        (g2["contype"] & g1["conaffinity"])):
                    continue
                if not self._pair_reachable(i, k, ball_cache):
                    continue
                # order so the lower type id comes first (plane first, etc.)
                if t1 <= t2:
                    pairs.append((i, k))
                else:
                    pairs.append((k, i))
        return tuple(pairs)

    # -- compile-time reachability sweep ------------------------------------
    #
    # For each candidate pair, bound each geom by a ball whose center is
    # FIXED in the frame of the pair's lowest common ancestor body and
    # whose radius covers every joint configuration of the bodies in
    # between (full rotation for unlimited hinge/ball joints; range +
    # generous soft-limit slack for limited ones).  If the two balls can
    # never intersect, the pair can never produce a contact.

    def _body_depths(self):
        if not hasattr(self, "_depth_cache") or len(
                self._depth_cache) != len(self.bodies):
            depth = [0] * len(self.bodies)
            for i in range(1, len(self.bodies)):
                depth[i] = depth[self.bodies[i]["parentid"]] + 1
            self._depth_cache = depth
        return self._depth_cache

    def _lca(self, b1, b2):
        depth = self._body_depths()
        while depth[b1] > depth[b2]:
            b1 = self.bodies[b1]["parentid"]
        while depth[b2] > depth[b1]:
            b2 = self.bodies[b2]["parentid"]
        while b1 != b2:
            b1 = self.bodies[b1]["parentid"]
            b2 = self.bodies[b2]["parentid"]
        return b1

    def _geom_ball_to(self, gid, ancestor, cache):
        """Ball (center, radius) in ``ancestor``'s frame containing geom
        ``gid`` under EVERY joint configuration of the bodies strictly
        below ancestor; None if unbounded (free joint / unlimited slide).
        """
        key = (gid, ancestor)
        if key in cache:
            return cache[key]
        g = self.geoms[gid]
        c = np.array(g["pos"], dtype=np.float64)
        c = c.copy()
        r = _geom_rbound(int(g["type"]), g["size"]) + float(g["margin"])
        b = g["bodyid"]
        out = None
        while True:
            if b == ancestor:
                out = (c, r)
                break
            body = self.bodies[b]
            ok = True
            # joints on this body act in the child frame, innermost last
            # in document order → process in reverse when lifting out
            for j in reversed(range(body["jntadr"],
                                    body["jntadr"] + body["jntnum"])):
                jnt = self.joints[j]
                c, r, ok = _joint_ball_sweep(jnt, c, r)
                if not ok:
                    break
            if not ok:
                break
            c = body["pos"] + _quat_rot(body["quat"], c)
            b = body["parentid"]
        cache[key] = out
        return out

    def _pair_reachable(self, i, k, cache):
        """False only when geoms i and k provably can never touch."""
        g1, g2 = self.geoms[i], self.geoms[k]
        # planes/hfields are unbounded: never prune
        if int(g1["type"]) <= 1 or int(g2["type"]) <= 1:
            return True
        a = self._lca(g1["bodyid"], g2["bodyid"])
        ball1 = self._geom_ball_to(i, a, cache)
        ball2 = self._geom_ball_to(k, a, cache)
        if ball1 is None or ball2 is None:
            return True
        (c1, r1), (c2, r2) = ball1, ball2
        return float(np.linalg.norm(c1 - c2)) <= r1 + r2 + 1e-9

    def _build_model(self) -> Model:
        def f(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64))

        bodies, joints, dofs, geoms, sites = (
            self.bodies, self.joints, self.dofs, self.geoms, self.sites)
        nb, nj, nvv, ng, ns = (len(bodies), len(joints), len(dofs),
                               len(geoms), len(sites))

        # rootid, subtreemass, tree levels
        rootid = [0] * nb
        for i in range(1, nb):
            p = bodies[i]["parentid"]
            rootid[i] = i if p == 0 else rootid[p]
        subtreemass = [b["mass"] for b in bodies]
        for i in range(nb - 1, 0, -1):
            subtreemass[bodies[i]["parentid"]] += subtreemass[i]
        depth = [0] * nb
        for i in range(1, nb):
            depth[i] = depth[bodies[i]["parentid"]] + 1
        levels = []
        for d in range(1, max(depth) + 1 if nb > 1 else 1):
            lv = tuple(i for i in range(nb) if depth[i] == d)
            if lv:
                levels.append(lv)

        weld = [0] * nb
        for i in range(1, nb):
            weld[i] = i if bodies[i]["dofnum"] > 0 else weld[bodies[i]["parentid"]]

        # dof ancestor mask (i row, j col): j is ancestor-or-self of i
        anc = np.zeros((nvv, nvv))
        for i in range(nvv):
            j = i
            while j >= 0:
                anc[i, j] = 1.0
                j = dofs[j]["parentid"]

        # body chain mask: dofs affecting each body
        chain = np.zeros((nb, nvv))
        for b in range(nb):
            bb = b
            while bb != 0:
                adr, num = bodies[bb]["dofadr"], bodies[bb]["dofnum"]
                if num > 0:
                    chain[b, adr:adr + num] = 1.0
                bb = bodies[bb]["parentid"]

        # geom rbound
        rbound = []
        for g in geoms:
            t, s = g["type"], g["size"]
            if t == GeomType.MESH and g.get("meshid", -1) >= 0:
                rbound.append(float(np.linalg.norm(
                    self.meshes[g["meshid"]].verts, axis=1).max()))
            else:
                rbound.append(_geom_rbound(int(t), s))

        names = NameMap(
            body={b["name"]: i for i, b in enumerate(bodies)},
            joint={j["name"]: i for i, j in enumerate(joints)},
            geom={g["name"]: i for i, g in enumerate(geoms)},
            site={s["name"]: i for i, s in enumerate(sites)},
            actuator={a["name"]: i for i, a in enumerate(self.actuators)},
            sensor={s["name"]: i for i, s in enumerate(self.sensors)},
            tendon={t["name"]: i for i, t in enumerate(self.tendons)},
            camera={c["name"]: i for i, c in enumerate(self.cams)},
            equality={e["name"]: i for i, e in enumerate(self.equalities)},
        )

        opt = Option(
            timestep=f(self.opt_timestep),
            gravity=f(self.opt_gravity),
            wind=f(self.opt_wind),
            magnetic=f(self.opt_magnetic),
            density=f(self.opt_density),
            viscosity=f(self.opt_viscosity),
            impratio=f(self.opt_impratio),
            tolerance=f(self.opt_tolerance),
            o_margin=f(self.opt_o_margin),
            o_solref=f([0.02, 1.0]),
            o_solimp=f([0.9, 0.95, 0.001, 0.5, 2.0]),
            integrator=self.opt_integrator,
            cone=self.opt_cone,
            solver=self.opt_solver,
            iterations=self.opt_iterations,
            ls_iterations=self.opt_ls_iterations,
            noslip_iterations=self.opt_noslip,
            disableflags=self.opt_disableflags,
        )

        # statistics (subset of mj_setConst; meaninertia patched by set_const)
        tot_mass = float(sum(b["mass"] for b in bodies))
        stat_el = self.root.first("statistic") or Element("statistic")
        stat = Statistic(
            meaninertia=f(1.0),
            meanmass=f(tot_mass / max(nb - 1, 1)),
            meansize=f(_float(stat_el.get("meansize"), 0.1)),
            extent=f(_float(stat_el.get("extent"), 1.0)),
            center=f(_floats(stat_el.get("center"), 3)
                     if stat_el.get("center") is not None else np.zeros(3)),
        )

        acts = self.actuators
        na = sum(1 for a in acts if a["dyntype"] != DynType.NONE)
        actadr = []
        aadr = 0
        for a in acts:
            if a["dyntype"] != DynType.NONE:
                actadr.append(aadr)
                aadr += 1
            else:
                actadr.append(-1)

        tendons, wraps = self.tendons, self.wraps
        jnames = {j["name"]: i for i, j in enumerate(joints)}
        snames = {s["name"]: i for i, s in enumerate(sites)}
        wrap_objid = []
        for w in wraps:
            if w["type"] == WrapType.JOINT:
                wrap_objid.append(jnames[w["objname"]])
            else:
                wrap_objid.append(snames[w["objname"]])

        m = Model(
            nq=self.nq, nv=self.nv, nu=len(acts), na=na, nbody=nb, njnt=nj,
            ngeom=ng, nsite=ns, ntendon=len(tendons), nwrap=len(wraps),
            nsensor=len(self.sensors),
            nsensordata=getattr(self, "nsensordata", 0),
            neq=len(self.equalities), ncam=len(self.cams),
            opt=opt, stat=stat,
            qpos0=f(self.qpos0), qpos_spring=f(self.qpos_spring),
            body_parentid=tuple(b["parentid"] for b in bodies),
            body_rootid=tuple(rootid),
            body_weldid=tuple(weld),
            body_jntadr=tuple(b["jntadr"] for b in bodies),
            body_jntnum=tuple(b["jntnum"] for b in bodies),
            body_dofadr=tuple(b["dofadr"] for b in bodies),
            body_dofnum=tuple(b["dofnum"] for b in bodies),
            body_geomadr=tuple(b["geomadr"] for b in bodies),
            body_geomnum=tuple(b["geomnum"] for b in bodies),
            body_pos=f([b["pos"] for b in bodies]),
            body_quat=f([b["quat"] for b in bodies]),
            body_ipos=f([b["ipos"] for b in bodies]),
            body_iquat=f([b["iquat"] for b in bodies]),
            body_mass=f([b["mass"] for b in bodies]),
            body_subtreemass=f(subtreemass),
            body_inertia=f([b["inertia"] for b in bodies]),
            body_invweight0=f(np.zeros((nb, 2))),
            jnt_type=tuple(int(j["type"]) for j in joints),
            jnt_qposadr=tuple(j["qposadr"] for j in joints),
            jnt_dofadr=tuple(j["dofadr"] for j in joints),
            jnt_bodyid=tuple(j["bodyid"] for j in joints),
            jnt_limited=tuple(int(j["limited"]) for j in joints),
            jnt_axis=f([j["axis"] for j in joints]) if nj else f(np.zeros((0, 3))),
            jnt_pos=f([j["pos"] for j in joints]) if nj else f(np.zeros((0, 3))),
            jnt_range=f([j["range"] for j in joints]) if nj else f(np.zeros((0, 2))),
            jnt_margin=f([j["margin"] for j in joints]) if nj else f(np.zeros(0)),
            jnt_stiffness=f([j["stiffness"] for j in joints]) if nj else f(np.zeros(0)),
            jnt_springdamper=tuple(tuple(float(x) for x in j["springdamper"])
                                   for j in joints),
            jnt_solref=f([j["solref"] for j in joints]) if nj else f(np.zeros((0, 2))),
            jnt_solimp=f([j["solimp"] for j in joints]) if nj else f(np.zeros((0, 5))),
            dof_bodyid=tuple(d["bodyid"] for d in dofs),
            dof_jntid=tuple(d["jntid"] for d in dofs),
            dof_parentid=tuple(d["parentid"] for d in dofs),
            dof_armature=f([d["armature"] for d in dofs]) if nvv else f(np.zeros(0)),
            dof_damping=f([d["damping"] for d in dofs]) if nvv else f(np.zeros(0)),
            dof_frictionloss=f([d["frictionloss"] for d in dofs]) if nvv else f(np.zeros(0)),
            dof_invweight0=f(np.zeros(nvv)),
            dof_solref=f([d["solref_fri"] for d in dofs]) if nvv else f(np.zeros((0, 2))),
            dof_solimp=f([d["solimp_fri"] for d in dofs]) if nvv else f(np.zeros((0, 5))),
            geom_type=tuple(int(g["type"]) for g in geoms),
            geom_contype=tuple(g["contype"] for g in geoms),
            geom_conaffinity=tuple(g["conaffinity"] for g in geoms),
            geom_condim=tuple(g["condim"] for g in geoms),
            geom_bodyid=tuple(g["bodyid"] for g in geoms),
            geom_priority=tuple(g["priority"] for g in geoms),
            geom_size=f([g["size"] for g in geoms]) if ng else f(np.zeros((0, 3))),
            geom_rbound=f(rbound) if ng else f(np.zeros(0)),
            geom_pos=f([g["pos"] for g in geoms]) if ng else f(np.zeros((0, 3))),
            geom_quat=f([g["quat"] for g in geoms]) if ng else f(np.zeros((0, 4))),
            geom_friction=f([g["friction"] for g in geoms]) if ng else f(np.zeros((0, 3))),
            geom_margin=f([g["margin"] for g in geoms]) if ng else f(np.zeros(0)),
            geom_gap=f([g["gap"] for g in geoms]) if ng else f(np.zeros(0)),
            geom_solmix=f([g["solmix"] for g in geoms]) if ng else f(np.zeros(0)),
            geom_solref=f([g["solref"] for g in geoms]) if ng else f(np.zeros((0, 2))),
            geom_solimp=f([g["solimp"] for g in geoms]) if ng else f(np.zeros((0, 5))),
            geom_rgba=f([g["rgba"] for g in geoms]) if ng else f(np.zeros((0, 4))),
            site_type=tuple(s["type"] for s in sites),
            site_bodyid=tuple(s["bodyid"] for s in sites),
            site_size=f([s["size"] for s in sites]) if ns else f(np.zeros((0, 3))),
            site_pos=f([s["pos"] for s in sites]) if ns else f(np.zeros((0, 3))),
            site_quat=f([s["quat"] for s in sites]) if ns else f(np.zeros((0, 4))),
            cam_bodyid=tuple(c["bodyid"] for c in self.cams),
            cam_mode=tuple(c["mode"] for c in self.cams),
            cam_targetbodyid=tuple(
                next((i for i, b in enumerate(self.bodies)
                      if b["name"] == c["target"]), -1)
                for c in self.cams),
            cam_pos=f([c["pos"] for c in self.cams])
            if self.cams else f(np.zeros((0, 3))),
            cam_quat=f([c["quat"] for c in self.cams])
            if self.cams else f(np.zeros((0, 4))),
            cam_fovy=f([c["fovy"] for c in self.cams])
            if self.cams else f(np.zeros(0)),
            cam_pos0=f(np.zeros((len(self.cams), 3))),
            cam_poscom0=f(np.zeros((len(self.cams), 3))),
            cam_mat0=f(np.tile(np.eye(3), (len(self.cams), 1, 1))),
            tendon_adr=tuple(t["adr"] for t in tendons),
            tendon_num=tuple(t["num"] for t in tendons),
            tendon_limited=tuple(int(t["limited"]) for t in tendons),
            tendon_range=f([t["range"] for t in tendons]) if tendons else f(np.zeros((0, 2))),
            tendon_margin=f([t["margin"] for t in tendons]) if tendons else f(np.zeros(0)),
            tendon_stiffness=f([t["stiffness"] for t in tendons]) if tendons else f(np.zeros(0)),
            tendon_damping=f([t["damping"] for t in tendons]) if tendons else f(np.zeros(0)),
            tendon_lengthspring=f([t["springlength"] for t in tendons]) if tendons else f(np.zeros((0, 2))),
            tendon_solref_lim=f([t["solref"] for t in tendons]) if tendons else f(np.zeros((0, 2))),
            tendon_solimp_lim=f([t["solimp"] for t in tendons]) if tendons else f(np.zeros((0, 5))),
            wrap_type=tuple(int(w["type"]) for w in wraps),
            wrap_objid=tuple(wrap_objid),
            wrap_prm=f([w["prm"] for w in wraps]) if wraps else f(np.zeros(0)),
            actuator_trntype=tuple(int(a["trntype"]) for a in acts),
            actuator_dyntype=tuple(int(a["dyntype"]) for a in acts),
            actuator_gaintype=tuple(int(a["gaintype"]) for a in acts),
            actuator_biastype=tuple(int(a["biastype"]) for a in acts),
            actuator_trnid=tuple((a["trnid"], -1) for a in acts),
            actuator_actadr=tuple(actadr),
            actuator_actnum=tuple(1 if a["dyntype"] != DynType.NONE else 0
                                  for a in acts),
            actuator_ctrllimited=tuple(int(a["ctrllimited"]) for a in acts),
            actuator_forcelimited=tuple(int(a["forcelimited"]) for a in acts),
            actuator_dynprm=f([a["dynprm"] for a in acts]) if acts else f(np.zeros((0, 10))),
            actuator_gainprm=f([a["gainprm"] for a in acts]) if acts else f(np.zeros((0, 10))),
            actuator_biasprm=f([a["biasprm"] for a in acts]) if acts else f(np.zeros((0, 10))),
            actuator_ctrlrange=f([a["ctrlrange"] for a in acts]) if acts else f(np.zeros((0, 2))),
            actuator_forcerange=f([a["forcerange"] for a in acts]) if acts else f(np.zeros((0, 2))),
            actuator_gear=f([a["gear"] for a in acts]) if acts else f(np.zeros((0, 6))),
            sensor_type=tuple(int(s["type"]) for s in self.sensors),
            sensor_objtype=tuple(int(s["objtype"]) for s in self.sensors),
            sensor_objid=tuple(s["objid"] for s in self.sensors),
            sensor_adr=tuple(s["adr"] for s in self.sensors),
            sensor_dim=tuple(s["dim"] for s in self.sensors),
            sensor_cutoff=f([s["cutoff"] for s in self.sensors])
            if self.sensors else f(np.zeros(0)),
            eq_type=tuple(int(e["type"]) for e in self.equalities),
            eq_obj1id=tuple(e["obj1id"] for e in self.equalities),
            eq_obj2id=tuple(e["obj2id"] for e in self.equalities),
            eq_active0=tuple(int(e["active"]) for e in self.equalities),
            eq_solref=f([e["solref"] for e in self.equalities])
            if self.equalities else f(np.zeros((0, 2))),
            eq_solimp=f([e["solimp"] for e in self.equalities])
            if self.equalities else f(np.zeros((0, 5))),
            eq_data=f([e["data"] for e in self.equalities])
            if self.equalities else f(np.zeros((0, 11))),
            nhfield=len(self.hfields),
            hfield_nrow=self.hfields[0]["nrow"] if self.hfields else 0,
            hfield_ncol=self.hfields[0]["ncol"] if self.hfields else 0,
            geom_dataid=tuple(
                (g["meshid"] if g["type"] == GeomType.MESH
                 else {h["name"]: i for i, h in enumerate(self.hfields)}
                 .get(g.get("hfieldname"), -1)) for g in geoms),
            nmesh=len(self.meshes),
            mesh_kdop=(f(np.stack([_mesh_kdop(mm) for mm in self.meshes]))
                       if self.meshes else f(np.zeros((0, 26)))),
            hfield_size=f([h["size"] for h in self.hfields])
            if self.hfields else f(np.zeros((0, 4))),
            hfield_data=f(np.zeros((self.hfields[0]["nrow"],
                                    self.hfields[0]["ncol"]))
                          if self.hfields else np.zeros((0, 0))),
            body_tree_levels=tuple(levels),
            collision_pairs=self._collision_pairs(),
            dof_ancestor_mask=f(anc),
            body_chain_mask=f(chain),
            names=names,
        )
        return m


# ---------------------------------------------------------------------------
# reachability-sweep helpers (host-side, float64).
# ---------------------------------------------------------------------------

#: soft joint limits can be violated transiently; limited joints get this
#: much extra travel on each side before a pair is declared unreachable
_REACH_SLACK_ANGLE = 0.35  # rad (~20 deg)
_REACH_SLACK_FRAC = 0.5    # plus 50% of the half-range


def _mesh_kdop(mesh) -> np.ndarray:
    from dm_control_torch.mjcf.mesh import kdop_supports

    return kdop_supports(mesh.verts)


def _geom_rbound(gtype: int, size) -> float:
    """Bounding radius about the geom frame origin (same rules as the
    Model's geom_rbound assembly)."""
    s = np.asarray(size, dtype=np.float64)
    t = GeomType(gtype)
    if t in (GeomType.PLANE, GeomType.HFIELD):
        return 0.0
    if t == GeomType.SPHERE:
        return float(s[0])
    if t == GeomType.CAPSULE:
        return float(s[0] + s[1])
    if t == GeomType.CYLINDER:
        return float(math.sqrt(s[0] ** 2 + s[1] ** 2))
    if t == GeomType.BOX or t == GeomType.MESH:
        # mesh size holds its AABB half-extents; the corner bounds it
        return float(np.linalg.norm(s))
    return float(np.max(s))


def _joint_ball_sweep(jnt, c, r):
    """Transforms a containing ball (c, r) through one joint's motion.

    Returns (c', r', bounded): the smallest easily-computed ball holding
    every placement of the input ball over the joint's (slack-extended)
    travel.  bounded=False means the joint's travel is unbounded and the
    caller must keep the pair.
    """
    t = JointType(jnt["type"])
    if t == JointType.FREE:
        return c, r, False
    jp = np.asarray(jnt["pos"], dtype=np.float64)
    axis = np.asarray(jnt["axis"], dtype=np.float64)
    if t == JointType.SLIDE:
        if not jnt["limited"]:
            return c, r, False
        lo, hi = float(jnt["range"][0]), float(jnt["range"][1])
        ref = float(jnt.get("ref", 0.0))
        mid, half = (lo + hi) / 2.0 - ref, (hi - lo) / 2.0
        half += _REACH_SLACK_FRAC * half + 0.02  # soft-limit slack (+2 cm)
        return c + axis * mid, r + half, True
    v = c - jp
    if t == JointType.BALL:
        amax = (float(jnt["range"][1]) if jnt["limited"] else math.pi)
        amax = min(math.pi, amax + _REACH_SLACK_ANGLE
                   + _REACH_SLACK_FRAC * amax)
        if amax >= math.pi:  # full rotation: ball about the anchor
            return jp, r + float(np.linalg.norm(v)), True
        return c, r + 2.0 * float(np.linalg.norm(v)) * math.sin(amax / 2), True
    # HINGE: rotation about `axis` through jp by q - ref, q in range
    if not jnt["limited"]:
        # axial component is invariant; radial sweeps a full circle
        a = axis / max(float(np.linalg.norm(axis)), _MINVAL)
        v_par = a * float(np.dot(v, a))
        v_perp = v - v_par
        return jp + v_par, r + float(np.linalg.norm(v_perp)), True
    lo, hi = float(jnt["range"][0]), float(jnt["range"][1])
    ref = float(jnt.get("ref", 0.0))
    mid, half = (lo + hi) / 2.0 - ref, (hi - lo) / 2.0
    half += _REACH_SLACK_ANGLE + _REACH_SLACK_FRAC * half
    a = axis / max(float(np.linalg.norm(axis)), _MINVAL)
    if half >= math.pi:
        v_par = a * float(np.dot(v, a))
        return jp + v_par, r + float(np.linalg.norm(v - v_par)), True
    c_mid = jp + _quat_rot(_axis_angle_quat(a, mid), v)
    v_perp = v - a * float(np.dot(v, a))
    chord = 2.0 * float(np.linalg.norm(v_perp)) * math.sin(half / 2.0)
    return c_mid, r + chord, True


# ---------------------------------------------------------------------------
# numpy quaternion / inertia helpers (host-side, float64).
# ---------------------------------------------------------------------------


def _quat_mul(u, v):
    w1, x1, y1, z1 = u
    w2, x2, y2, z2 = v
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_rot(q, v):
    w, u = q[0], q[1:]
    c = np.cross(u, v)
    return v + 2 * (w * c + np.cross(u, c))


def _axis_angle_quat(axis, angle):
    return np.concatenate([[math.cos(angle / 2)],
                           np.asarray(axis) * math.sin(angle / 2)])


def _euler_to_quat(euler, seq):
    q = np.array([1.0, 0, 0, 0])
    basis = {"x": np.array([1.0, 0, 0]), "y": np.array([0, 1.0, 0]),
             "z": np.array([0, 0, 1.0])}
    for i, ax in enumerate(seq):
        rot = _axis_angle_quat(basis[ax.lower()], float(euler[i]))
        # lowercase = moving (intrinsic) frame → post-multiply;
        # uppercase = fixed (extrinsic) frame → pre-multiply
        # (MJCF compiler/eulerseq semantics; verified against
        # mjModel.geom_quat for euler="100 2 0")
        q = _quat_mul(q, rot) if ax.islower() else _quat_mul(rot, q)
    return q / np.linalg.norm(q)


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _mat_to_quat(m):
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def _z_to_quat(z):
    """Minimal rotation mapping (0,0,1) to direction z."""
    z = np.asarray(z, dtype=np.float64)
    n = np.linalg.norm(z)
    if n < _MINVAL:
        return np.array([1.0, 0, 0, 0])
    z = z / n
    axis = np.cross([0.0, 0, 1.0], z)
    s = np.linalg.norm(axis)
    if s < _MINVAL:
        if z[2] > 0:
            return np.array([1.0, 0, 0, 0])
        return np.array([0.0, 1.0, 0, 0])  # 180° about x
    axis = axis / s
    angle = math.atan2(s, z[2])
    return _axis_angle_quat(axis, angle)


def _principal(imat):
    """Symmetric inertia matrix → (principal values, axes).

    Matches MuJoCo's convention: an already-diagonal matrix is kept as-is
    (identity frame, original axis order); otherwise eigendecompose with
    eigenvalues in decreasing order.
    """
    off = abs(imat[0, 1]) + abs(imat[0, 2]) + abs(imat[1, 2])
    if off == 0.0:  # exactly diagonal (MuJoCo keeps order; no eigh)
        return np.diag(imat).copy(), np.eye(3)
    vals, vecs = np.linalg.eigh(imat)
    order = np.argsort(vals)[::-1]
    vals, vecs = vals[order], vecs[:, order]
    if np.linalg.det(vecs) < 0:
        vecs[:, 2] = -vecs[:, 2]
    return vals, vecs


def _geom_volume_inertia(gtype: GeomType, size):
    """Returns (volume, unit-mass diagonal inertia in geom frame)."""
    if gtype == GeomType.SPHERE:
        r = size[0]
        vol = 4.0 / 3.0 * math.pi * r ** 3
        i = 2.0 / 5.0 * r * r
        return vol, np.array([i, i, i])
    if gtype == GeomType.CAPSULE:
        r, h = size[0], size[1]
        vs = 4.0 / 3.0 * math.pi * r ** 3
        vc = math.pi * r * r * 2 * h
        vol = vs + vc
        ws, wc = vs / vol, vc / vol  # mass fractions at equal density
        axial = ws * 0.4 * r * r + wc * 0.5 * r * r
        trans = (ws * (0.4 * r * r + h * h + 0.75 * r * h)
                 + wc * (r * r / 4.0 + h * h / 3.0))
        return vol, np.array([trans, trans, axial])
    if gtype == GeomType.CYLINDER:
        r, h = size[0], size[1]
        vol = math.pi * r * r * 2 * h
        axial = 0.5 * r * r
        trans = (3 * r * r + 4 * h * h) / 12.0
        return vol, np.array([trans, trans, axial])
    if gtype == GeomType.BOX:
        a, b, c = size
        vol = 8 * a * b * c
        return vol, np.array([(b * b + c * c) / 3.0, (a * a + c * c) / 3.0,
                              (a * a + b * b) / 3.0])
    if gtype == GeomType.ELLIPSOID:
        a, b, c = size
        vol = 4.0 / 3.0 * math.pi * a * b * c
        return vol, np.array([(b * b + c * c) / 5.0, (a * a + c * c) / 5.0,
                              (a * a + b * b) / 5.0])
    # plane / hfield / mesh: no implicit mass
    return 0.0, np.zeros(3)


def compile_model(root: Element, device=None,
                  dtype: torch.dtype = torch.float64,
                  validate: bool = True) -> Model:
    """Compiles an MJCF element tree into a ``Model`` on ``device`` (the
    card unless the caller asks for another, as ``device="cpu"``) with
    its floating leaves in ``dtype``.

    The tree is compiled and ``engine.set_const`` run in float64 on the
    host, so the constants do not depend on the device; the model is then
    moved to ``device``, a float32 one cast as ``model_io.load`` casts a
    float64 file.  ``validate=False`` skips the MJCF schema check
    (mjcf/schema.py).
    """
    from dm_control_torch.physics import model_io

    device = target_device(device)
    if validate:
        from dm_control_torch.mjcf import schema

        schema.validate_or_raise(root)
    return model_io.to(compile_host(root), device, dtype)


def target_device(device) -> torch.device:
    """``device``, the card where it is None; raises where it is the card
    and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"compile_model: device {str(device)!r} but CUDA is not "
            f"available; pass device='cpu' to compile for the CPU")
    return device


def compile_host(root: Element) -> Model:
    """The float64 model of ``root`` on the host, with its constants
    (``engine.set_const``); no schema check."""
    from dm_control_torch.physics import engine

    return engine.set_const(_Compiler(root).compile())
