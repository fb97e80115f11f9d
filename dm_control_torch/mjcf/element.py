"""A lightweight MJCF element tree (DOM).

The port's copy of ``dm_control_tpu/mjcf/element.py``, with its hooks
into ``mjcf/debugging.py``: with debug mode on, an element records the
stack of its creation and of every attribute write (one flag test an
element and a write with it off).

The reference's PyMJCF builds a schema-validated DOM with attachment and
binding (dm_control/mjcf/element.py).  This module provides the core DOM
used by both the XML parser and programmatic model builders.  Attribute
*names* are validated by the grammar in ``mjcf.schema``; attribute
*values* are validated eagerly on every write by the typed descriptors in
``mjcf.attribute`` (the analogue of the reference's attribute objects,
dm_control/mjcf/attribute.py:48-464), so a bad value fails at assignment
with the element path in the message rather than deep in the compiler.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from dm_control_torch.mjcf import attribute as _attribute
from dm_control_torch.mjcf import debugging


class _Attrib(dict):
    """Attribute dict that type-checks values as they are written."""

    __slots__ = ("_owner",)

    def __init__(self, owner: "Element", items):
        super().__init__()
        self._owner = owner
        for k, v in dict(items or {}).items():
            self[k] = v

    def __setitem__(self, key, value):
        # owner may be mid-reconstruction (deepcopy restores dict items
        # before the element's slots); such values were validated when
        # first written, so skip the re-check
        tag = getattr(self._owner, "tag", None) if hasattr(self, "_owner") \
            else None
        if value is not None and tag is not None:
            _attribute.check_value(tag, key, value, self._owner.path)
            if debugging.debug_mode_enabled():
                debugging.record_attribute_write(self._owner, key)
        super().__setitem__(key, value)

    def update(self, *args, **kw):  # keep validation on bulk writes
        for k, v in dict(*args, **kw).items():
            self[k] = v


class Element:
    """An MJCF element: tag, attributes, ordered children."""

    # ``payload``: optional in-memory asset bytes for file-referencing
    # elements (mesh/hfield/texture), used by export_with_assets
    __slots__ = ("tag", "attrib", "children", "parent", "payload")

    def __init__(self, tag: str, attrib: Optional[Dict[str, object]] = None,
                 parent: Optional["Element"] = None):
        self.tag = tag
        self.parent = parent
        self.attrib: Dict[str, object] = _Attrib(self, attrib)
        self.children: List[Element] = []
        if debugging.debug_mode_enabled():
            debugging.record_origin(self)

    # -- construction -------------------------------------------------------

    def add(self, tag: str, **attrib) -> "Element":
        """Appends and returns a new child element (PyMJCF ``Element.add``)."""
        child = Element(tag, attrib, parent=self)
        self.children.append(child)
        return child

    def remove(self, child: "Element") -> None:
        self.children.remove(child)
        child.parent = None

    def attach(self, child_root: "Element",
               prefix: Optional[str] = None) -> "Element":
        """Attaches another <mujoco> model here, returning its attachment
        frame body (PyMJCF attach: reference mjcf/element.py:900,1149).
        Valid on the root (merge under worldbody), a body (merge under
        it), or a site (frame at the site's pose on its owning body)."""
        from dm_control_torch.mjcf.attachment import element_attach

        return element_attach(self, child_root, prefix)

    def detach(self) -> None:
        """Removes this element from its parent; for attachment frames
        this also sweeps the merged namescoped elements (prefixed
        actuators/tendons/assets/sensors) out of the top-level sections
        (reference attachment-frame detach, mjcf/element.py:957)."""
        if self.parent is None:
            raise RuntimeError(f"<{self.tag}> has no parent to detach "
                               "from")
        from dm_control_torch.mjcf.attachment import detach_frame

        detach_frame(self)

    # -- queries ------------------------------------------------------------

    def get(self, key: str, default=None):
        return self.attrib.get(key, default)

    @property
    def name(self) -> Optional[str]:
        return self.attrib.get("name")

    @property
    def path(self) -> str:
        """Root-to-here path like ``mujoco/worldbody/body[pole]/geom``."""
        label = self.tag
        attrib = getattr(self, "attrib", None)  # mid-construction safe
        name = attrib.get("name") if attrib else None
        if name:
            label = f"{label}[{name}]"
        if self.parent is None:
            return label
        return f"{self.parent.path}/{label}"

    def find_all(self, tag: str) -> List["Element"]:
        """All descendants with the given tag, in document order."""
        out = []
        for c in self.iter():
            if c.tag == tag:
                out.append(c)
        return out

    def find(self, tag: str, name: str) -> Optional["Element"]:
        for c in self.find_all(tag):
            if c.attrib.get("name") == name:
                return c
        return None

    def first(self, tag: str) -> Optional["Element"]:
        for c in self.children:
            if c.tag == tag:
                return c
        return None

    def iter(self) -> Iterator["Element"]:
        """Depth-first iteration including self."""
        yield self
        for c in self.children:
            yield from c.iter()

    # -- serialization ------------------------------------------------------

    def to_xml_string(self, indent: int = 0) -> str:
        """Serializes back to MJCF XML (for debugging and oracle tests)."""
        pad = "  " * indent
        attrs = " ".join(
            f'{k}="{_fmt(v)}"' for k, v in self.attrib.items() if v is not None
        )
        open_tag = f"{pad}<{self.tag}{(' ' + attrs) if attrs else ''}"
        if not self.children:
            return open_tag + "/>"
        lines = [open_tag + ">"]
        for c in self.children:
            lines.append(c.to_xml_string(indent + 1))
        lines.append(f"{pad}</{self.tag}>")
        return "\n".join(lines)

    def __repr__(self):
        return f"<Element {self.tag} {dict(self.attrib)}>"


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return " ".join(_fmt(x) for x in v)
    if isinstance(v, float):
        return repr(v)
    return str(v)
