"""XML helpers over the mjcf Element tree.

The port's copy of ``dm_control_tpu/utils/xml_tools.py`` (reference:
dm_control/utils/xml_tools.py:23-44, which is lxml-based)."""

from __future__ import annotations

from dm_control_torch.mjcf.element import Element
from dm_control_torch.mjcf.parser import from_xml_string


def find_element(root: Element, tag: str, name: str) -> Element:
    """First element with the given tag and name attribute (raises if
    absent)."""
    result = root.find(tag, name)
    if result is None:
        raise ValueError(f"Element with tag {tag!r} and name {name!r} "
                         f"not found.")
    return result


def nested_element(element: Element, depth: int) -> Element:
    """Wraps ``element`` into ``depth`` nested copies of itself (the
    reference uses this to build repeated chains)."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    root = Element(element.tag, dict(element.attrib))
    current = root
    for _ in range(depth - 1):
        child = current.add(element.tag, **dict(element.attrib))
        current = child
    return root


def parse(xml_string_or_file):
    """Parses XML (string or file object) into an Element tree."""
    if hasattr(xml_string_or_file, "read"):
        xml_string_or_file = xml_string_or_file.read()
    return from_xml_string(xml_string_or_file)
