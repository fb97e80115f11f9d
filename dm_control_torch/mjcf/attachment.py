"""Element-level model attachment (PyMJCF attach semantics).

The port's copy of ``dm_control_tpu/mjcf/attachment.py``.

The reference exposes attach at two levels: ``mjcf_model.attach(other)``
(dm_control/mjcf/element.py:1149) and ``site.attach(model)``
(:900) — both merge the child model into the parent tree under a
namescope prefix and return the attachment frame body.  Here the same
tree-merge (prefixing, name-collision rejection, top-level section
merging, frame wrapping) is one function shared by ``Element.attach``
and the composer's ``Entity.attach``.
"""

from __future__ import annotations

import copy
from typing import Optional

from dm_control_torch.mjcf.element import Element

#: name-reference attributes rewritten when a tree is prefixed
REF_ATTRS = ("joint", "site", "tendon", "body", "body1", "body2",
             "joint1", "joint2", "tendon1", "tendon2", "objname",
             "target", "hfield", "mesh", "material", "texture",
             "childclass", "class", "actuator", "geom", "geom1", "geom2",
             "prefix")

#: top-level sections merged (not nested) on attach
MERGE_SECTIONS = ("asset", "actuator", "sensor", "tendon", "equality",
                  "contact", "default")


def prefix_tree(elem: Element, prefix: str) -> None:
    """Prefixes every name and name-reference in ``elem``'s subtree."""
    for e in elem.iter():
        if "name" in e.attrib:
            e.attrib["name"] = prefix + str(e.attrib["name"])
        for attr in REF_ATTRS:
            if attr in e.attrib and attr != "prefix":
                e.attrib[attr] = prefix + str(e.attrib[attr])


def attach_model(root: Element, child_root: Element, prefix: str,
                 attach_site: Optional[Element] = None,
                 copy_child: bool = True) -> Element:
    """Merges ``child_root`` (an <mujoco> tree) into ``root`` under
    ``prefix`` ('name/'), returning the attachment frame body.

    Mirrors the reference namescope semantics: prefixed child
    identifiers must not collide with names already present
    (mjcf/namescope.py); the child worldbody's content is wrapped at
    ``attach_site`` (a body/site element of ``root``) or under
    ``root``'s worldbody; asset/actuator/sensor/tendon/equality/
    contact/default sections merge at top level.
    """
    if copy_child:
        child_root = copy.deepcopy(child_root)
    # canonicalize BOTH trees to radians before merging: the merged tree
    # compiles under one <compiler angle> setting, so a radian child
    # under a degree root (or vice versa) would silently re-interpret
    # every angle attribute (PyMJCF avoids this by canonicalizing to
    # radians at parse time; see mjcf/units.py)
    from dm_control_torch.mjcf.units import to_radians

    to_radians(root)
    to_radians(child_root)
    prefix_tree(child_root, prefix)

    own_names = {(e.tag, e.attrib["name"]) for e in root.iter()
                 if e.attrib.get("name") is not None}
    clashes = [(e.tag, e.attrib["name"]) for e in child_root.iter()
               if e.attrib.get("name") is not None
               and (e.tag, e.attrib["name"]) in own_names]
    if clashes:
        raise ValueError(
            f"Attaching under prefix {prefix!r} would duplicate names: "
            f"{clashes[:5]} (attach each model instance under a unique "
            f"prefix)")

    if attach_site is not None and attach_site.tag == "site":
        # reference site.attach: the frame sits on the site's owning
        # body, at the site's local pose — every orientation spelling
        # the compiler accepts (quat/euler/axisangle/zaxis/xyaxes) must
        # carry over, not just quat
        parent_elem = attach_site.parent
        site_pose = {k: attach_site.attrib[k]
                     for k in ("pos", "quat", "euler", "axisangle",
                               "zaxis", "xyaxes")
                     if k in attach_site.attrib}
    else:
        parent_elem = attach_site
        site_pose = {}
    if parent_elem is None:
        parent_elem = root.first("worldbody")
    if parent_elem is None:
        parent_elem = root.add("worldbody")

    child_world = child_root.first("worldbody")
    world_children = list(child_world.children) if child_world else []
    only_bodies = [c for c in world_children if c.tag == "body"]
    if (len(world_children) == 1 and len(only_bodies) == 1
            and not site_pose):
        # single root body: use it directly as the attachment frame —
        # a massless wrapper body with a free joint would be rejected
        # by the physics (moving bodies need mass)
        frame = only_bodies[0]
        frame.attrib.setdefault("name", prefix.rstrip("/"))
        frame.parent = parent_elem
        parent_elem.children.append(frame)
    else:
        frame = parent_elem.add("body", name=prefix.rstrip("/"),
                                **site_pose)
        for c in world_children:
            c.parent = frame
            frame.children.append(c)

    for section in MERGE_SECTIONS:
        child_sec = child_root.first(section)
        if child_sec is None:
            continue
        own = root.first(section)
        if own is None:
            own = root.add(section)
        for c in child_sec.children:
            c.parent = own
            own.children.append(c)
    return frame


def _root_of(elem: Element) -> Element:
    e = elem
    while e.parent is not None:
        e = e.parent
    return e


def detach_frame(frame: Element) -> None:
    """Removes an attachment frame AND every namescoped element the
    attach merged into top-level sections (actuators, tendons, assets,
    sensors, ...) — the reference's attachment-frame detach removes the
    whole namescope, not just the subtree (mjcf/element.py:957)."""
    root = _root_of(frame)
    name = str(frame.attrib.get("name", ""))
    # the frame is either the wrapper body named exactly like the
    # namescope ('h1') or — single-root-body attach — the child's own
    # prefixed root body ('h1/palm'); the namescope is the first segment
    prefix = (name.split("/")[0] + "/") if name else ""
    if frame.parent is not None:
        frame.parent.remove(frame)
    if not prefix or prefix == "/":
        return
    for section in MERGE_SECTIONS:
        sec = root.first(section)
        if sec is None:
            continue
        for c in list(sec.children):
            name = c.attrib.get("name")
            if name is not None and str(name).startswith(prefix):
                sec.remove(c)


def element_attach(self: Element, child_root: Element,
                   prefix: Optional[str] = None) -> Element:
    """``Element.attach``: PyMJCF-style attach on an <mujoco> root, a
    body, or a site.

    - on the root: merges under the worldbody
      (reference mjcf/element.py:1149 RootElement.attach)
    - on a body: merges under that body
    - on a site: wraps at the site's pose on its owning body
      (reference mjcf/element.py:900 site attach)

    Returns the attachment frame body.
    """
    if self.tag not in ("mujoco", "body", "site", "worldbody"):
        raise ValueError(
            f"attach() is valid on mujoco/worldbody/body/site elements, "
            f"not <{self.tag}>")
    if child_root.tag != "mujoco":
        raise ValueError("the attached model must be an <mujoco> root")
    if prefix is None:
        base = (child_root.attrib.get("model")
                or self.attrib.get("name") or "attachment")
        prefix = str(base) + "/"
    root = _root_of(self)
    site = None if self.tag in ("mujoco", "worldbody") else self
    return attach_model(root, child_root, prefix, attach_site=site)
