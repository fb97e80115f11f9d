"""Typed MJCF attribute descriptors.

The port's copy of ``dm_control_tpu/mjcf/attribute.py``.

The reference PyMJCF attaches typed attribute objects (String/Integer/
Float/Keyword/Array/Reference/File, dm_control/mjcf/attribute.py:48-464)
to every element so that invalid *values* fail at assignment time.  This
module is the equivalent value layer over this framework's string-keyed
DOM: a curated descriptor table keyed by (tag, attribute) plus
name-based fallbacks, consulted by ``Element`` on every attribute write
(construction, ``add``, and ``attrib[...] =``).

Values are validated and normalized-for-checking but stored in their
original form (string or python value) — the compiler remains the single
place that materializes numeric arrays, so validation adds no storage
semantics, only early failure with the element path in the message.

Asset-carrying attributes (mesh/hfield/texture ``file``) accept an
``Asset`` payload object unifying in-memory asset bytes with their
on-disk extension (reference attribute.py:426-464).
"""

from __future__ import annotations

import numbers
from typing import Dict, Optional, Tuple


class MJCFAttributeError(ValueError):
    """An attribute value that cannot be valid MJCF."""


class Asset:
    """In-memory asset contents + the extension MuJoCo infers type from."""

    __slots__ = ("contents", "extension", "prefix")

    def __init__(self, contents: bytes, extension: str, prefix: str = ""):
        self.contents = contents
        self.extension = extension if extension.startswith(".") \
            else "." + extension
        self.prefix = prefix

    def get_vfs_filename(self) -> str:
        """A stable in-tree filename derived from the contents hash."""
        import hashlib

        digest = hashlib.sha1(self.contents).hexdigest()[:16]
        stem = f"{self.prefix}-{digest}" if self.prefix else digest
        return stem + self.extension

    def __eq__(self, other):
        return (isinstance(other, Asset)
                and self.contents == other.contents
                and self.extension == other.extension)

    def __hash__(self):
        return hash((self.contents, self.extension))


# -- descriptors -------------------------------------------------------------


class _Descriptor:
    kind = "value"

    def check(self, value, where: str) -> None:
        raise NotImplementedError

    def fail(self, value, where: str, why: str) -> None:
        raise MJCFAttributeError(
            f"{where}: invalid {self.kind} {value!r} ({why})")


def _floats_of(value):
    """Splits a value into float components (str, scalar, or sequence)."""
    if isinstance(value, str):
        return [float(tok) for tok in value.split()]
    if isinstance(value, numbers.Number):
        return [float(value)]
    try:
        return [float(v) for v in value]  # sequences / numpy arrays
    except TypeError:
        return [float(value)]


class Float(_Descriptor):
    kind = "float"

    def check(self, value, where):
        try:
            vals = _floats_of(value)
        except (ValueError, TypeError):
            return self.fail(value, where, "not a number")
        if len(vals) != 1:
            self.fail(value, where, f"expected 1 value, got {len(vals)}")


class Int(_Descriptor):
    kind = "integer"

    def check(self, value, where):
        try:
            if isinstance(value, str):
                int(value)
            elif isinstance(value, numbers.Number):
                if int(value) != value:
                    raise ValueError
            else:
                raise TypeError
        except (ValueError, TypeError):
            self.fail(value, where, "not an integer")


class Bool(_Descriptor):
    kind = "boolean"
    _WORDS = {"true", "false"}

    def check(self, value, where):
        if isinstance(value, bool):
            return
        if isinstance(value, str) and value.strip() in self._WORDS:
            return
        self.fail(value, where, "expected true/false")


class Keyword(_Descriptor):
    kind = "keyword"

    def __init__(self, *options: str, extra_bool: bool = False):
        self.options = set(options)
        if extra_bool:
            self.options |= {"true", "false"}

    def check(self, value, where):
        if str(value) not in self.options:
            self.fail(value, where, f"one of {sorted(self.options)}")


class Array(_Descriptor):
    kind = "array"

    def __init__(self, length: Optional[int] = None,
                 lengths: Optional[Tuple[int, ...]] = None):
        #: exact length, or any of ``lengths``, or free-length when both
        #: are None
        self.length = length
        self.lengths = lengths

    def check(self, value, where):
        try:
            vals = _floats_of(value)
        except (ValueError, TypeError):
            return self.fail(value, where, "not a numeric array")
        if self.length is not None and len(vals) != self.length:
            self.fail(value, where,
                      f"expected {self.length} values, got {len(vals)}")
        if self.lengths is not None and len(vals) not in self.lengths:
            self.fail(value, where,
                      f"expected {self.lengths} values, got {len(vals)}")


class String(_Descriptor):
    kind = "string"

    def check(self, value, where):
        if not isinstance(value, str):
            self.fail(value, where, "expected a string")


class Identifier(String):
    """Names: non-empty (reference attribute.py:123; ``/`` is allowed —
    it is this framework's namescope separator, written into names by
    composer attach prefixing — and MuJoCo itself permits spaces)."""

    kind = "identifier"

    def check(self, value, where):
        super().check(value, where)
        if not value or "\\" in value or "\n" in value:
            self.fail(value, where, "not a valid identifier")


class Reference(String):
    """A by-name reference into another namespace; existence is resolved
    by the compiler (which knows the whole model), the type layer only
    requires a non-empty name."""

    kind = "reference"

    def __init__(self, namespace: str):
        self.namespace = namespace

    def check(self, value, where):
        super().check(value, where)
        if not value:
            self.fail(value, where, f"empty {self.namespace} reference")


class File(_Descriptor):
    """A file path or an in-memory ``Asset`` payload."""

    kind = "file"

    def check(self, value, where):
        if isinstance(value, (Asset, bytes)):
            return
        if not isinstance(value, str) or not value:
            self.fail(value, where, "expected a path or Asset")


# -- the descriptor table ----------------------------------------------------

_FLOAT = Float()
_INT = Int()
_BOOL = Bool()
_STRING = String()
_NAME = Identifier()
_ARRAY = Array()
_VEC2 = Array(2)
_VEC3 = Array(3)
_QUAT = Array(4)
_FILE = File()

#: attribute-name fallbacks used when (tag, attr) has no specific entry
BY_NAME: Dict[str, _Descriptor] = {
    "name": _NAME,
    "class": _STRING,
    "childclass": _STRING,
    "pos": _VEC3,
    "quat": _QUAT,
    "euler": _VEC3,
    "zaxis": _VEC3,
    "axisangle": _QUAT,
    "xyaxes": Array(6),
    "fromto": Array(6),
    "axis": _VEC3,
    "range": _VEC2,
    "ctrlrange": _VEC2,
    "forcerange": _VEC2,
    "actrange": _VEC2,
    "actuatorfrcrange": _VEC2,
    "solref": _ARRAY,
    "solimp": _ARRAY,
    "solreflimit": _ARRAY,
    "solimplimit": _ARRAY,
    "solreffriction": _ARRAY,
    "solimpfriction": _ARRAY,
    "friction": _ARRAY,
    "gear": _ARRAY,
    "damping": _FLOAT,
    "armature": _FLOAT,
    "stiffness": _FLOAT,
    "springref": _FLOAT,
    "frictionloss": _FLOAT,
    "margin": _FLOAT,
    "gap": _FLOAT,
    "mass": _FLOAT,
    "density": _FLOAT,
    "timestep": _FLOAT,
    "timeconst": _FLOAT,
    "fovy": _FLOAT,
    "ipd": _FLOAT,
    "limited": Keyword("auto", extra_bool=True),
    "ctrllimited": Keyword("auto", extra_bool=True),
    "forcelimited": Keyword("auto", extra_bool=True),
    "actlimited": Keyword("auto", extra_bool=True),
    "actuatorfrclimited": Keyword("auto", extra_bool=True),
    "mocap": _BOOL,
    "active": _BOOL,
    "file": _FILE,
    "joint": Reference("joint"),
    "joint1": Reference("joint"),
    "joint2": Reference("joint"),
    "tendon1": Reference("tendon"),
    "tendon2": Reference("tendon"),
    "geom1": Reference("geom"),
    "geom2": Reference("geom"),
    "body1": Reference("body"),
    "body2": Reference("body"),
    "site1": Reference("site"),
    "site2": Reference("site"),
    "hfield": Reference("hfield"),
    "mesh": Reference("mesh"),
    "material": Reference("material"),
    "target": Reference("body"),
    "slidersite": Reference("site"),
    "cranksite": Reference("site"),
    "kp": _FLOAT,
    "kv": _FLOAT,
    "dampratio": _FLOAT,
    "polycoef": _ARRAY,
    "anchor": _VEC3,
    "relpose": Array(7),
    "gravity": _VEC3,
    "wind": _VEC3,
    "magnetic": _VEC3,
    "iterations": _INT,
    "ls_iterations": _INT,
    "noslip_iterations": _INT,
    "tolerance": _FLOAT,
    "impratio": _FLOAT,
    "nconmax": _INT,
    "njmax": _INT,
    "nrow": _INT,
    "ncol": _INT,
    "condim": _INT,
    "priority": _INT,
    "group": _INT,
    "contype": _INT,
    "conaffinity": _INT,
    "diaginertia": _VEC3,
    "fullinertia": Array(6),
    "springdamper": _VEC2,
    "springlength": Array(lengths=(1, 2)),
    "gravcomp": _FLOAT,
    "ref": _FLOAT,
    "coef": _FLOAT,
    "scale": _ARRAY,
    "width": _FLOAT,
    "cutoff": _FLOAT,
    "noise": _FLOAT,
    "time": _FLOAT,
    "qpos": _ARRAY,
    "qvel": _ARRAY,
    "act": _ARRAY,
    "ctrl": _ARRAY,
    "mpos": _ARRAY,
    "mquat": _ARRAY,
    "data": _ARRAY,
    "user": _ARRAY,
    "elevation": _ARRAY,
    "vertex": _ARRAY,
    "face": _ARRAY,
    "normal": _ARRAY,
    "texcoord": _ARRAY,
    "dynprm": _ARRAY,
    "gainprm": _ARRAY,
    "biasprm": _ARRAY,
}

#: (tag, attr) specific descriptors — override BY_NAME
BY_TAG_ATTR: Dict[Tuple[str, str], _Descriptor] = {
    ("option", "integrator"): Keyword("Euler", "RK4", "implicit",
                                      "implicitfast"),
    ("option", "cone"): Keyword("pyramidal", "elliptic"),
    ("option", "solver"): Keyword("PGS", "CG", "Newton"),
    ("option", "jacobian"): Keyword("dense", "sparse", "auto"),
    ("option", "collision"): Keyword("all", "predefined", "dynamic"),
    ("joint", "type"): Keyword("free", "ball", "slide", "hinge"),
    ("geom", "type"): Keyword("plane", "hfield", "sphere", "capsule",
                              "ellipsoid", "cylinder", "box", "mesh",
                              "sdf"),
    ("site", "type"): Keyword("sphere", "capsule", "ellipsoid", "cylinder",
                              "box"),
    ("camera", "mode"): Keyword("fixed", "track", "trackcom", "targetbody",
                                "targetbodycom"),
    ("compiler", "angle"): Keyword("degree", "radian"),
    ("compiler", "coordinate"): Keyword("local", "global"),
    ("compiler", "inertiafromgeom"): Keyword("auto", extra_bool=True),
    ("compiler", "autolimits"): _BOOL,
    ("compiler", "balanceinertia"): _BOOL,
    ("mesh", "inertia"): Keyword("convex", "exact", "legacy", "shell"),
    ("geom", "size"): Array(lengths=(1, 2, 3, 6)),
    ("site", "size"): Array(lengths=(1, 2, 3)),
    ("hfield", "size"): Array(4),
    ("size", "memory"): _STRING,
    ("numeric", "size"): _INT,
    ("general", "dyntype"): Keyword("none", "integrator", "filter",
                                    "filterexact", "muscle", "user"),
    ("general", "gaintype"): Keyword("fixed", "affine", "muscle", "user"),
    ("general", "biastype"): Keyword("none", "affine", "muscle", "user"),
    ("motor", "joint"): Reference("joint"),
    ("statistic", "center"): _VEC3,
    ("statistic", "extent"): _FLOAT,
    ("statistic", "meansize"): _FLOAT,
    ("statistic", "meanmass"): _FLOAT,
    ("statistic", "meaninertia"): _FLOAT,
    ("text", "data"): _STRING,
    ("mujoco", "model"): _STRING,
    ("body", "user"): _ARRAY,
    ("key", "time"): _FLOAT,
    ("adhesion", "body"): Reference("body"),
    ("adhesion", "gain"): _FLOAT,
    ("touch", "site"): Reference("site"),
    ("camera", "target"): Reference("body"),
}

# flag attributes are all enable/disable keywords
_FLAG_KW = Keyword("enable", "disable")
for _attr in ("constraint", "contact", "energy", "gravity", "equality",
              "frictionloss", "limit", "passive", "warmstart",
              "filterparent", "actuation", "refsafe", "sensor", "override",
              "clampctrl", "fwdinv", "multiccd", "eulerdamp"):
    BY_TAG_ATTR[("flag", _attr)] = _FLAG_KW


def descriptor_for(tag: str, attr: str) -> Optional[_Descriptor]:
    """The descriptor validating (tag, attr), or None (unchecked)."""
    d = BY_TAG_ATTR.get((tag, attr))
    if d is not None:
        return d
    return BY_NAME.get(attr)


def check_value(tag: str, attr: str, value, where: str) -> None:
    """Validates one attribute value; raises MJCFAttributeError with the
    element path on failure.  ``None`` clears an attribute — always ok."""
    if value is None:
        return
    d = descriptor_for(tag, attr)
    if d is not None:
        d.check(value, f"{where}@{attr}")
