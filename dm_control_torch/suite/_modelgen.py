"""Model literal trees → MJCF element trees.

The runtime half of ``dm_control_tpu/suite/_modelgen.py``: the literal
trees under ``suite/models/`` are ``(tag, attrs_dict, [children])``
nested tuples (models-as-code, no XML at runtime).  The dev-time
generator that writes them from the reference's XML stays in the JAX
package.
"""

from __future__ import annotations

from dm_control_torch.mjcf.element import Element


def to_element(lit) -> Element:
    """Runtime loader: literal tree → Element tree."""
    tag, attrs, children = lit
    e = Element(tag, dict(attrs))
    for c in children:
        child = to_element(c)
        child.parent = e
        e.children.append(child)
    return e
