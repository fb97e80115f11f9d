"""A 2x4 Duplo brick with real stud-coupling snap dynamics (counterpart
of ``dm_control_tpu/entities/props/duplo/__init__.py``).

Reference: dm_control/entities/props/duplo/__init__.py:50 (Duplo
entity), duplo2x4.xml (brick geometry).  The physical dimensions of a
2x4 Duplo brick and the tuned contact engineering (solref/solimp,
contype/conaffinity bitmask scheme, tuned stud radii) are transcribed
as data; the model is built programmatically through this framework's
element API rather than shipped as an XML file.

How the snap works (all primitive geometry — no meshes):

- The top of the brick carries 8 stud cylinders (r ~ 4.7 mm).  The
  underside is hollow: 3 tubes (r 6.7 mm) down the centerline, thin
  perimeter walls, and optional flanges.
- When one brick is pressed onto another, each stud sits diagonally
  between two tubes of the upper brick.  The stud-center-to-tube-center
  distance (11.3 mm) is slightly LESS than r_stud + r_tube, so the
  contacts are in permanent interference; friction on those loaded
  contacts resists separation.
- The stud radius therefore modulates the separation force, which is
  how the reference autotunes "snap" strength (``duplo/autotune.py``,
  which bisects over the radius with ``duplo/utils.py``'s
  ``measure_separation_force``).

Collision bitmask scheme (reference duplo2x4.xml defaults): bricks see
each other's shells via base (contype 3 / conaffinity 2); studs
(contype 5 / conaffinity 4) engage walls, tubes, and flanges (contype
4 / conaffinity 0) of the OTHER brick only — a geom never collides
with its sibling geoms because they share one body.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from dm_control_torch import composer
from dm_control_torch.composer.observation.observable import Generic
from dm_control_torch.mjcf.element import Element

# Stud radii are drawn from a uniform distribution; `variation` scales
# the min/max while keeping the lower quartile fixed.  The radii are
# tuned so separation forces match the empirical distribution measured
# for real Duplo bricks (reference __init__.py:35-44 — tuned data).
# Measured on THIS engine: radius 0.004647 (flanges, no easy_align)
# separates at 12.7 N — inside the real-brick range [6, 18] N; rerun
# the JAX package's autotune.tune_all_variants() to retarget exactly.
_StudSize = collections.namedtuple(
    "_StudSize", ["minimum", "lower_quartile", "maximum"])
_StudParams = collections.namedtuple(
    "_StudParams", ["easy_align", "flanges"])

_STUD_SIZE_PARAMS = {
    _StudParams(easy_align=False, flanges=False):
        _StudSize(0.004685, 0.004781, 0.004898),
    _StudParams(easy_align=False, flanges=True):
        _StudSize(0.004609, 0.004647, 0.004716),
    _StudParams(easy_align=True, flanges=False):
        _StudSize(0.004754, 0.004844, 0.004953),
    _StudParams(easy_align=True, flanges=True):
        _StudSize(0.004695, 0.004717, 0.004765),
}

#: brick outer height (m): stacking pitch of engaged bricks
BRICK_HEIGHT = 0.0192

# stud/hole grid: 2 rows (x) by 4 columns (y), 16 mm pitch
_ROWS_X = (-0.008, 0.008)
_COLS_Y = (-0.024, -0.008, 0.008, 0.024)


def _fmt(*vals):
    return " ".join(f"{v:g}" for v in vals)


def _make_duplo_model(color):
    """Builds the duplo2x4 model tree (geometry data cited above)."""
    root = Element("mujoco", {"model": "duplo2x4"})
    rgba = _fmt(*color, 1.0)

    top = root.add("default")
    dup = Element("default", {"class": "duplo"}, parent=top)
    top.children.append(dup)
    dup.add("site", type="sphere", size="0.001", group="5",
            rgba="1 0 0 0.3")
    dup.add("geom", friction=".35", solimp=".99 .999 .001",
            solref=".01 1", rgba=rgba)
    for cls, attrs in (
            ("base", dict(type="box", pos="0 0 0.0096",
                          size="0.0159 0.0318 0.0096", contype="3",
                          conaffinity="2", group="4", mass="0",
                          rgba=rgba)),
            ("wall", dict(type="box", contype="4", conaffinity="0")),
            ("flange", dict(type="box", size=".0008 .00055 .0087",
                            contype="0", conaffinity="0")),
            ("stud", dict(type="cylinder", size=".0047 .0023",
                          density="500", margin=".0001", contype="5",
                          conaffinity="4")),
            ("stud-capsule", dict(type="capsule", size=".005 .0023",
                                  density="500", group="3", mass="0",
                                  contype="0", conaffinity="0")),
            ("tube", dict(type="cylinder", size=".0066999 .0078",
                          density="300", contype="4", conaffinity="0")),
    ):
        sub = Element("default", {"class": cls}, parent=dup)
        dup.children.append(sub)
        sub.add("geom", **attrs)

    wb = root.add("worldbody")
    body = wb.add("body", name="brick", childclass="duplo")

    def geom(name, cls, **attrs):
        body.add("geom", name=name, **{"class": cls}, **attrs)

    geom("base", "base")
    # outer shell walls of the hollow underside
    geom("wall_x0", "wall", pos="-.0151 0 .0088", size=".0008 .0302 .0088")
    geom("wall_x1", "wall", pos="+.0151 0 .0088", size=".0008 .0302 .0088")
    geom("wall_y0", "wall", pos="0 -.031 .0088", size=".0159 .0008 .0088")
    geom("wall_y1", "wall", pos="0 +.031 .0088", size=".0159 .0008 .0088")
    geom("wall_z1", "wall", pos="0 0 .0184", size=".0159 .0318 .0008")

    body.add("site", name="bounding_box", type="box",
             size="0.016 0.0319 0.012", pos="0 0 0.0119", group="3")

    # stud/hole sites mark engagement points for task logic
    for r, x in enumerate(_ROWS_X):
        for c, y in enumerate(_COLS_Y):
            body.add("site", name=f"stud_{r}{c}", pos=_fmt(x, y, 0.0238))
            body.add("site", name=f"hole_{r}{c}", pos=_fmt(x, y, 0.0046))
    # stud cylinders (x offset 0.05 mm breaks perfect symmetry so the
    # wedge contacts load deterministically) + easy-align capsules
    for r, x in enumerate(_ROWS_X):
        sx = x - 0.00005 if x < 0 else x + 0.00005
        for c, y in enumerate(_COLS_Y):
            geom(f"stud_{r}{c}", "stud", pos=_fmt(sx, y, 0.0215))
            geom(f"studcap_{r}{c}", "stud-capsule", pos=_fmt(x, y, 0.0215))
    # flanges along the long (x) faces of the cavity...
    for r, x in enumerate((-0.0135, 0.0135)):
        for c, y in enumerate(_COLS_Y):
            geom(f"flange_{r}{c}", "flange", pos=_fmt(x, y, 0.00885))
    # ...and across the short (y) faces (same 0.05 mm wedge offset as
    # the studs — these are active contact geoms when flanges=True)
    for r, x in enumerate(_ROWS_X):
        fx = x - 0.00005 if x < 0 else x + 0.00005
        for c, y in enumerate((-0.02945, 0.02945)):
            geom(f"flange_{r}{c}y", "flange", pos=_fmt(fx, y, 0.00885),
                 quat="1 0 0 1")
    # hollow tubes down the centerline — the stud wedge partners
    for i, y in enumerate((-0.016, 0.0, 0.016)):
        geom(f"tube_{i}", "tube", pos=_fmt(0.0, y, 0.0098))
    # inner cavity walls
    geom("inner_x0", "wall", pos="-.01045 0 .011", size=".00385 .00055 .0066")
    geom("inner_x1", "wall", pos="+.01045 0 .011", size=".00385 .00055 .0066")
    geom("inner_y0", "wall", pos="0 -.008 .0132", size=".0004 .0014 .0044")
    geom("inner_y1", "wall", pos="0 .008 .0132", size=".0004 .0014 .0044")

    sensor = root.add("sensor")
    sensor.add("framepos", name="position", objtype="site",
               objname="bounding_box")
    sensor.add("framequat", name="orientation", objtype="site",
               objname="bounding_box")
    sensor.add("framelinvel", name="linear_velocity", objtype="site",
               objname="bounding_box")
    sensor.add("frameangvel", name="angular_velocity", objtype="site",
               objname="bounding_box")
    sensor.add("force", name="force", site="bounding_box")
    return root


def _find_default(root, cls):
    for e in root.iter():
        if e.tag == "default" and e.get("class") == cls:
            return e
    raise KeyError(cls)


_COLOR_NOT_BETWEEN_0_AND_1 = (
    "All values in `color` must be between 0 and 1, got {!r}.")

_instance_count = 0


class Duplo(composer.Entity):
    """A 2x4 Duplo brick (reference duplo/__init__.py:50)."""

    def _build(self, easy_align=False, flanges=True, variation=0.0,
               color=(1.0, 0.0, 0.0), name=None):
        """Args mirror the reference:

        easy_align: capsule studs (rounded tops align more forgivingly).
        flanges: enable the cavity flanges — costlier dynamics, but
          bricks click together in partially-overlapping positions.
        variation: 0.0 = deterministic separation force (the mode of
          the empirical Duplo distribution); 1.0 = match the measured
          spread.
        color: (R, G, B) floats in [0, 1].
        """
        if not all(0 <= v <= 1 for v in color):
            raise ValueError(_COLOR_NOT_BETWEEN_0_AND_1.format(color))
        self._mjcf_root = _make_duplo_model(color)
        if name is None:
            # unique per-instance namescope (the reference gets this
            # from PyMJCF's auto-uniquifying namescope)
            global _instance_count
            name = f"duplo{_instance_count}"
            _instance_count += 1
        self._mjcf_root.attrib["model"] = name

        self._easy_align = easy_align
        stud = _find_default(self._mjcf_root, "stud")
        if easy_align:
            # hide the cylinder studs from contact, activate capsules
            g = stud.first("geom")
            g.attrib.update(group="3", contype="9", conaffinity="8")
            cap = _find_default(self._mjcf_root, "stud-capsule")
            cg = cap.first("geom")
            # capsules stay massless (mass="0"): the hidden cylinder
            # studs already carry the density-derived stud mass, so
            # giving the capsules mass would double-count ~1.3 g
            cg.attrib.update(group="0", contype="0", conaffinity="4")
            self._active_stud_geom = cg
        else:
            self._active_stud_geom = stud.first("geom")

        if flanges:
            fg = _find_default(self._mjcf_root, "flange").first("geom")
            fg.attrib["contype"] = "4"

        stud_size = _STUD_SIZE_PARAMS[_StudParams(easy_align, flanges)]
        offset = (1.0 - variation) * stud_size.lower_quartile
        self._lower = offset + variation * stud_size.minimum
        self._upper = offset + variation * stud_size.maximum

        self._studs = np.empty((2, 4), dtype=object)
        self._holes = np.empty((2, 4), dtype=object)
        for r in range(2):
            for c in range(4):
                self._studs[r, c] = self._mjcf_root.find(
                    "site", f"stud_{r}{c}")
                self._holes[r, c] = self._mjcf_root.find(
                    "site", f"hole_{r}{c}")

    def set_stud_radius(self, radius):
        """Sets the active stud radius on THIS entity's element tree.

        Only effective before the brick is attached/compiled: Entity.attach
        deep-copies the tree, so post-attach edits here never reach the
        compiled model.  Use :meth:`apply_stud_radius` (a model-array
        write) for per-episode changes after compilation.
        """
        length = str(self._active_stud_geom.attrib["size"]).split()[1]
        self._active_stud_geom.attrib["size"] = f"{radius:.6g} {length}"

    @property
    def stud_radius(self):
        return float(
            str(self._active_stud_geom.attrib["size"]).split()[0])

    def _stud_geom_ids(self, model):
        """Compiled-model geom ids of the 8 active stud geoms, resolving
        the attach prefix ('<name>/stud_00' after Entity.attach)."""
        base = "studcap" if self._easy_align else "stud"
        prefix = str(self._mjcf_root.attrib.get("model", "")) + "/"
        if prefix + f"{base}_00" not in model.names.geom:
            prefix = ""  # compiled standalone (no attach prefix)
        return [model.names.geom[f"{prefix}{base}_{r}{c}"]
                for r in range(2) for c in range(4)]

    def apply_stud_radius(self, physics, radius):
        """Writes the stud radius into the COMPILED model arrays.

        The environment compiles the MJCF tree once at construction;
        per-episode geometry changes are value-only model updates.  Updates
        geom_size and the broadphase bounding radius consistently with the
        compiler (mjcf/compiler.py geom-rbound rules), on the host in the
        model's dtype, and gives the physics the new model.  ``replace``
        gives that model an empty cache, so nothing derived from the old
        model's arrays is read after it.
        """
        m = physics.model
        ids = self._stud_geom_ids(m)
        size = m.geom_size.cpu().numpy().copy()
        rbound = m.geom_rbound.cpu().numpy().copy()
        size[ids, 0] = radius
        half = size[ids, 1]
        if self._easy_align:  # capsule: r + half-length
            rbound[ids] = radius + half
        else:  # cylinder: corner distance
            rbound[ids] = np.sqrt(radius ** 2 + half ** 2)
        physics._model = m.replace(
            geom_size=torch.as_tensor(size, device=m.device),
            geom_rbound=torch.as_tensor(rbound, device=m.device))
        physics.mark_as_dirty()

    def initialize_episode(self, physics, random_state):
        """Randomizes stud radius (and therefore separation force) —
        applied to the compiled model so it works after attach."""
        self.apply_stud_radius(
            physics, random_state.uniform(self._lower, self._upper))

    @property
    def studs(self):
        """(2, 4) array of stud site elements."""
        return self._studs

    @property
    def holes(self):
        """(2, 4) array of hole site elements (engagement partners)."""
        return self._holes

    def position(self, physics):
        """World position of the brick's attachment frame."""
        pos, _quat = self.get_pose(physics)
        return np.asarray(pos)

    def _sensor(self, physics, name):
        frame = self.attachment_frame
        prefix = ""
        if frame is not None:
            fname = str(frame.get("name", ""))
            if "/" in fname:
                prefix = fname.split("/")[0] + "/"
        return np.asarray(physics.named_field("sensordata", prefix + name))

    def _build_observables(self):
        obs = composer.Observables(self)
        for name in ("position", "orientation", "linear_velocity",
                     "angular_velocity", "force"):
            obs.add_observable(name, Generic(
                lambda phys, n=name: self._sensor(phys, n)))
        return obs
