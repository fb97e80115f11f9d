"""Copy elements across element trees.

The port's copy of ``dm_control_tpu/mjcf/copier.py``.

Reference: dm_control/mjcf/copier.py — deep-copies an element (with its
subtree) into another model's matching section, keeping referenced
defaults intact by committing them first.
"""

from __future__ import annotations

import copy as _copy

from dm_control_torch.mjcf.traversal_utils import commit_defaults


def copy_element(element, new_parent, commit_class_defaults: bool = True):
    """Deep-copies ``element`` (and subtree) under ``new_parent`` in a
    possibly different model; returns the copy.

    Class defaults are committed onto the copy first so it doesn't
    depend on the source model's <default> tree."""
    clone = _copy.deepcopy(element)
    if commit_class_defaults:
        src_root = element
        while src_root.parent is not None:
            src_root = src_root.parent
        for e in clone.iter():
            commit_defaults(e, root=src_root)
            e.attrib.pop("class", None)
            e.attrib.pop("childclass", None)
    clone.parent = new_parent
    new_parent.children.append(clone)
    return clone
