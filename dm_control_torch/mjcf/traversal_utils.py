"""Element-tree traversal utilities.

The port's copy of ``dm_control_tpu/mjcf/traversal_utils.py``.

Reference: dm_control/mjcf/traversal_utils.py — ``commit_defaults``
resolves the <default> class hierarchy onto concrete elements so the
tree is self-contained, and helpers walk attachment scopes.
"""

from __future__ import annotations

from typing import Dict


def _collect_defaults(root) -> Dict[str, Dict[str, Dict[str, object]]]:
    """class name -> tag -> attribute dict, with nested <default> classes
    inheriting from their parents."""
    table: Dict[str, Dict[str, Dict[str, object]]] = {}

    def walk(default_elem, inherited):
        cls = str(default_elem.get("class", ""))
        merged = {tag: dict(attrs) for tag, attrs in inherited.items()}
        for child in default_elem.children:
            if child.tag == "default":
                continue
            merged.setdefault(child.tag, {}).update(child.attrib)
        table[cls] = merged
        for child in default_elem.children:
            if child.tag == "default":
                walk(child, merged)

    for top in root.children:
        if top.tag == "default":
            walk(top, {})
    return table


def commit_defaults(element, root=None, attributes=None) -> None:
    """Copies default-class attribute values onto ``element`` for any
    attribute it doesn't set explicitly (reference
    traversal_utils.commit_defaults)."""
    if root is None:
        root = element
        while root.parent is not None:
            root = root.parent
    table = _collect_defaults(root)
    # resolve the element's class: own class attr, else nearest ancestor
    # childclass, else the anonymous top default
    cls = element.get("class")
    node = element.parent
    while cls is None and node is not None:
        cls = node.get("childclass")
        node = node.parent
    cls = str(cls) if cls is not None else ""
    for c in (cls, ""):
        defaults = table.get(c, {}).get(element.tag, {})
        for attr, value in defaults.items():
            if attributes is not None and attr not in attributes:
                continue
            if attr not in element.attrib:
                element.attrib[attr] = value


def get_attachment_frame(mjcf_model):
    """The <body> wrapping an attached model, or None
    (reference traversal_utils.get_attachment_frame)."""
    return getattr(mjcf_model, "attachment_frame", None)
