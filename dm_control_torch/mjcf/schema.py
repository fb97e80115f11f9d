"""MJCF schema validation.

The port's copy of ``dm_control_tpu/mjcf/schema.py``.

Reference: dm_control/mjcf/schema.py parses a 1,926-line schema.xml into
element/attribute specs.  Here the grammar is a curated table covering
the MJCF subset this compiler implements (plus visual-only tags accepted
pass-through), giving the same developer affordance: typos in tags or
attributes fail at model-construction time with a did-you-mean hint
instead of silently compiling wrong physics.
"""

from __future__ import annotations

import difflib
from typing import Dict, List, Set

# Attributes valid on every element.
_GLOBAL_ATTRS = {"name", "class", "childclass", "group"}

# Visual/debug-only tags: accepted with any attributes (they don't reach
# the physics compiler).
VISUAL_TAGS = {
    "visual", "map", "quality", "headlight", "global", "rgba", "scale",
    "light", "texture", "material", "skin", "texlayer",
}

_POSE = {"pos", "quat", "euler", "xyaxes", "zaxis", "axisangle", "fromto"}

# tag -> allowed attributes (beyond _GLOBAL_ATTRS)
ATTRIBUTES: Dict[str, Set[str]] = {
    "mujoco": {"model"},
    "include": {"file"},
    "compiler": {"angle", "coordinate", "inertiafromgeom", "meshdir",
                 "texturedir", "settotalmass", "autolimits",
                 "boundmass", "boundinertia", "balanceinertia",
                 "eulerseq", "discardvisual", "fusestatic"},
    "option": {"timestep", "integrator", "cone", "solver", "iterations",
               "ls_iterations", "noslip_iterations", "noslip_tolerance",
               "ls_tolerance", "tolerance",
               "gravity", "wind", "magnetic", "density", "viscosity",
               "impratio", "collision", "jacobian", "o_margin",
               "o_solref", "o_solimp", "apirate", "timeconst"},
    "flag": {"constraint", "contact", "energy", "gravity", "equality",
             "frictionloss", "limit", "passive", "warmstart", "filterparent",
             "actuation", "refsafe", "sensor", "override", "clampctrl",
             "fwdinv", "multiccd", "eulerdamp"},
    "size": {"nconmax", "njmax", "nkey", "nstack", "nuserdata",
             "nuser_body", "nuser_jnt", "nuser_geom", "nuser_site",
             "nuser_actuator", "nuser_sensor", "memory"},
    "statistic": {"center", "extent", "meansize", "meanmass",
                  "meaninertia"},
    "default": set(),
    "worldbody": set(),
    "body": _POSE | {"mocap", "gravcomp", "user"},
    "inertial": {"pos", "quat", "mass", "diaginertia", "fullinertia",
                 "euler", "xyaxes", "zaxis"},
    "joint": _POSE | {"type", "axis", "range", "limited", "damping",
                      "armature", "stiffness", "springref", "springdamper",
                      "frictionloss", "ref", "margin", "solreflimit",
                      "solimplimit", "solreffriction", "solimpfriction",
                      "coef", "joint", "user", "actuatorfrclimited",
                      "actuatorfrcrange",
                      # <equality><joint> coupling form
                      "joint1", "joint2", "polycoef"},
    "freejoint": set(),
    "geom": _POSE | {"type", "size", "contype", "conaffinity", "condim",
                     "priority", "friction", "solmix", "solref", "solimp",
                     "margin", "gap", "mass", "density", "shellinertia",
                     "material", "rgba", "hfield", "mesh", "fitscale",
                     "user"},
    "site": _POSE | {"type", "size", "material", "rgba", "site", "user"},
    "camera": _POSE | {"mode", "target", "fovy", "ipd", "focal",
                       "focalpixel", "principal", "principalpixel",
                       "resolution", "sensorsize", "user"},
    "mocap": set(),
    "asset": set(),
    "mesh": {"file", "scale", "vertex", "face", "normal", "texcoord",
             "smoothnormal", "maxhullvert", "inertia"},
    "hfield": {"file", "nrow", "ncol", "size", "elevation"},
    "contact": set(),
    "exclude": {"body1", "body2"},
    "pair": {"geom1", "geom2", "condim", "friction", "solref", "solimp",
             "solreffriction", "margin", "gap"},
    "equality": {"solref", "solimp"},
    "connect": {"body1", "body2", "anchor", "active", "solref", "solimp",
                "site1", "site2"},
    "weld": {"body1", "body2", "relpose", "anchor", "active", "solref",
             "solimp", "torquescale", "site1", "site2"},
    # <tendon> appears both as an equality constraint (tendon1/tendon2/
    # polycoef) and as a defaults-class entry carrying fixed/spatial
    # tendon attributes (e.g. rodent.xml's vertebral tendon defaults)
    "tendon": {"tendon1", "tendon2", "polycoef", "solref", "solimp",
               "width", "active", "limited", "range", "stiffness",
               "damping", "springlength", "frictionloss", "margin",
               "solreflimit", "solimplimit", "solreffriction",
               "solimpfriction", "material", "rgba", "group", "user"},
    "fixed": {"stiffness", "damping", "limited", "range", "springlength",
              "width", "solreflimit", "solimplimit", "frictionloss",
              "user"},
    "spatial": {"stiffness", "damping", "limited", "range", "springlength",
                "width", "solreflimit", "solimplimit", "frictionloss",
                "material", "rgba", "user"},
    "actuator": set(),
    "general": {"joint", "tendon", "site", "jointinparent", "ctrllimited",
                "ctrlrange", "forcelimited", "forcerange", "gear",
                "dyntype", "gaintype", "biastype", "dynprm", "gainprm",
                "biasprm", "actlimited", "actrange", "actdim", "actearly",
                "cranklength", "slidersite", "cranksite", "user"},
    "motor": {"joint", "tendon", "site", "jointinparent", "ctrllimited",
              "ctrlrange", "forcelimited", "forcerange", "gear", "user"},
    "position": {"joint", "tendon", "site", "jointinparent", "ctrllimited",
                 "ctrlrange", "forcelimited", "forcerange", "gear", "kp",
                 "kv", "dampratio", "inheritrange", "user"},
    "velocity": {"joint", "tendon", "site", "jointinparent", "ctrllimited",
                 "ctrlrange", "forcelimited", "forcerange", "gear", "kv",
                 "user"},
    "cylinder": {"joint", "tendon", "site", "ctrllimited", "ctrlrange",
                 "forcelimited", "forcerange", "gear", "timeconst", "area",
                 "diameter", "bias", "user"},
    "muscle": {"joint", "tendon", "ctrllimited", "ctrlrange", "forcelimited",
               "forcerange", "gear", "timeconst", "range", "force", "scale",
               "lmin", "lmax", "vmax", "fpmax", "fvmax", "user"},
    "adhesion": {"body", "ctrlrange", "gain", "forcelimited", "forcerange",
                 "user"},
    "sensor": set(),
    "keyframe": set(),
    "key": {"time", "qpos", "qvel", "act", "ctrl", "mpos", "mquat"},
    "custom": set(),
    "numeric": {"size", "data"},
    "text": {"data"},
}

# sensor tags share one attribute set
_SENSOR_ATTRS = {"site", "joint", "body", "tendon", "actuator", "objtype",
                 "objname", "reftype", "refname", "cutoff", "noise",
                 "user"}
for _s in ("touch", "accelerometer", "velocimeter", "gyro", "force",
           "torque", "magnetometer", "rangefinder", "jointpos", "jointvel",
           "tendonpos", "tendonvel", "actuatorpos", "actuatorvel",
           "actuatorfrc", "ballquat", "ballangvel", "jointlimitpos",
           "jointlimitvel", "jointlimitfrc", "tendonlimitpos",
           "tendonlimitvel", "tendonlimitfrc", "framepos", "framequat",
           "framexaxis", "frameyaxis", "framezaxis", "framelinvel",
           "frameangvel", "framelinacc", "frameangacc", "subtreecom",
           "subtreelinvel", "subtreeangmom", "user", "clock"):
    ATTRIBUTES[_s] = set(_SENSOR_ATTRS)

# tag -> allowed child tags
CHILDREN: Dict[str, Set[str]] = {
    "mujoco": {"include", "compiler", "option", "size", "statistic",
               "default", "custom", "asset", "worldbody", "contact",
               "equality", "tendon", "actuator", "sensor", "keyframe",
               "visual"},
    "option": {"flag"},
    "default": ({"default", "mesh", "material", "joint", "geom", "site",
                 "camera", "light", "pair", "equality", "tendon", "fixed",
                 "spatial", "general", "motor", "position", "velocity",
                 "cylinder", "muscle", "adhesion"}),
    "worldbody": {"body", "geom", "site", "camera", "light", "mocap"},
    "body": {"body", "inertial", "joint", "freejoint", "geom", "site",
             "camera", "light"},
    "asset": {"mesh", "hfield", "texture", "material", "skin"},
    "contact": {"exclude", "pair"},
    "equality": {"connect", "weld", "joint", "tendon", "distance"},
    "tendon": {"fixed", "spatial"},
    "fixed": {"joint"},
    "spatial": {"site", "geom", "pulley"},
    "actuator": {"general", "motor", "position", "velocity", "cylinder",
                 "muscle", "adhesion"},
    "sensor": set(k for k in ATTRIBUTES
                  if ATTRIBUTES[k] is not None
                  and ATTRIBUTES.get(k) == set(_SENSOR_ATTRS)),
    "keyframe": {"key"},
    "custom": {"numeric", "text"},
}
# equality/joint child: <joint> under <equality> reuses joint attrs plus
# joint1/joint2/polycoef
ATTRIBUTES["distance"] = {"geom1", "geom2", "distance", "solref", "solimp",
                          "active"}

KEYWORDS = {
    ("option", "integrator"): {"Euler", "RK4", "implicit", "implicitfast"},
    ("option", "cone"): {"pyramidal", "elliptic"},
    ("joint", "type"): {"free", "ball", "slide", "hinge"},
    ("geom", "type"): {"plane", "hfield", "sphere", "capsule", "ellipsoid",
                       "cylinder", "box", "mesh", "sdf"},
    ("site", "type"): {"sphere", "capsule", "ellipsoid", "cylinder",
                       "box"},
    ("compiler", "angle"): {"degree", "radian"},
}


class MJCFSchemaError(ValueError):
    """A tag or attribute not in the MJCF grammar."""


def _suggest(word: str, options) -> str:
    close = difflib.get_close_matches(word, list(options), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def validate(root, path: str = "") -> List[str]:
    """Validates an element tree against the grammar; returns a list of
    error strings (empty = valid)."""
    errors: List[str] = []

    def walk(elem, path):
        tag = elem.tag
        if tag in VISUAL_TAGS:
            return  # visual-only subtree: pass-through
        here = f"{path}/{tag}"
        allowed = ATTRIBUTES.get(tag)
        if allowed is None:
            errors.append(
                f"{here}: unknown element <{tag}>"
                f"{_suggest(tag, ATTRIBUTES)}")
            return
        for attr in elem.attrib:
            if attr in _GLOBAL_ATTRS or attr in allowed:
                kw = KEYWORDS.get((tag, attr))
                if kw is not None and str(elem.attrib[attr]) not in kw:
                    errors.append(
                        f"{here}@{attr}: invalid keyword "
                        f"{elem.attrib[attr]!r} (one of {sorted(kw)})")
                continue
            errors.append(
                f"{here}: unknown attribute {attr!r}"
                f"{_suggest(attr, allowed | _GLOBAL_ATTRS)}")
        kids = CHILDREN.get(tag)
        for child in elem.children:
            if child.tag in VISUAL_TAGS:
                continue
            if kids is not None and kids and child.tag not in kids:
                errors.append(
                    f"{here}: element <{child.tag}> not allowed here"
                    f"{_suggest(child.tag, kids)}")
                continue
            walk(child, here)

    walk(root, path)
    return errors


def validate_or_raise(root) -> None:
    errors = validate(root)
    if errors:
        msg = "\n  ".join(errors[:20])
        raise MJCFSchemaError(
            f"MJCF schema validation failed:\n  {msg}")
