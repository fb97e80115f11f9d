"""XML → MJCF element tree.

The port's copy of ``dm_control_tpu/mjcf/parser.py``, on the standard
library's ``xml.etree.ElementTree`` where that one uses ``lxml`` (which
the port does not need).  ElementTree's default tree builder already
drops comments and processing instructions, which the JAX parser skips.

Analogue of dm_control/mjcf/parser.py:28-109 (from_xml_string / from_path /
_parse), including ``<include file=.../>`` resolution against either the
filesystem or an in-memory asset dict (the reference resolves includes via
MuJoCo's VFS, dm_control/mujoco/wrapper/core.py:210-260).
"""

from __future__ import annotations

import os
from typing import Dict, Optional
from xml.etree import ElementTree

from dm_control_torch.mjcf.element import Element


def _parse(xml) -> ElementTree.Element:
    return ElementTree.fromstring(xml.encode() if isinstance(xml, str)
                                  else xml)


def from_xml_string(xml: str, assets: Optional[Dict[str, bytes]] = None,
                    base_dir: Optional[str] = None) -> Element:
    return _convert(_parse(xml), assets or {}, base_dir)


def from_path(path: str, assets: Optional[Dict[str, bytes]] = None) -> Element:
    with open(path, "rb") as f:
        xml = f.read()
    return from_xml_string(xml, assets=assets, base_dir=os.path.dirname(path))


def _read_include(fname: str, assets: Dict[str, bytes], base_dir):
    if fname in assets:
        return assets[fname]
    if base_dir is not None:
        full = os.path.join(base_dir, fname)
        if os.path.exists(full):
            with open(full, "rb") as f:
                return f.read()
    raise IOError(f"Cannot resolve <include file={fname!r}>.")


#: asset elements whose ``file`` payload the compiler may need
_PAYLOAD_TAGS = frozenset({"mesh", "hfield", "texture", "skin"})


def _convert(node, assets, base_dir, parent: Optional[Element] = None) -> Element:
    elem = Element(node.tag, dict(node.attrib), parent=parent)
    if node.tag in _PAYLOAD_TAGS and "file" in node.attrib:
        fname = node.attrib["file"]
        if fname in assets:
            elem.payload = assets[fname]
        elif base_dir:
            path = os.path.join(base_dir, fname)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    elem.payload = f.read()
    for child in node:
        if child.tag == "include":
            inc_xml = _read_include(child.attrib["file"], assets, base_dir)
            inc_root = _parse(inc_xml)
            if inc_root.tag != "mujoco":
                raise ValueError("<include> file must have a <mujoco> root.")
            # Included children are merged in place (MuJoCo include semantics:
            # the contents of the included file's root replace the directive).
            for inc_child in inc_root:
                _merge_child(elem, _convert(inc_child, assets, base_dir,
                                            parent=elem))
        else:
            _merge_child(elem, _convert(child, assets, base_dir,
                                        parent=elem))
    return elem


# Top-level sections that MuJoCo merges rather than duplicates when they
# appear multiple times (e.g. once in the including file, once included).
_MERGEABLE = {"asset", "worldbody", "actuator", "sensor", "tendon",
              "equality", "contact", "default", "deformable", "keyframe"}


def _merge_child(parent: Element, child: Element) -> None:
    if parent.tag == "mujoco" and child.tag in _MERGEABLE:
        existing = parent.first(child.tag)
        if existing is not None:
            for grandchild in child.children:
                grandchild.parent = existing
                existing.children.append(grandchild)
            # Merge attributes (e.g. <default> has none at top level).
            for k, v in child.attrib.items():
                existing.attrib.setdefault(k, v)
            return
    parent.children.append(child)
