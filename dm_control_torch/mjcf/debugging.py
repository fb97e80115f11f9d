"""MJCF debugging: creation/modification stack tracking and debug dumps.

The port's copy of ``dm_control_tpu/mjcf/debugging.py``.  Reference:
dm_control/mjcf/debugging.py — when enabled, records the
Python stack at element creation and at every attribute write, so
compile errors point at the code that built the element; a full debug dump
writes the model XML with per-element origin comments plus the complete
stack traces to a dump directory.

Enable programmatically (``enable_debug_mode()``) or via the environment
(``PYMJCF_DEBUG=1``, ``PYMJCF_DEBUG_FULL_DUMP_DIR=/path`` — the same
knobs the reference exposes as absl flags).
"""

from __future__ import annotations

import contextlib
import os
import traceback
from typing import Dict, List, Optional, Tuple

_ENABLED = os.environ.get("PYMJCF_DEBUG", "") not in ("", "0")
_DUMP_DIR = os.environ.get("PYMJCF_DEBUG_FULL_DUMP_DIR", "")
_ORIGINS: Dict[int, "_StackRecord"] = {}
_ATTR_WRITES: Dict[Tuple[int, str], "_StackRecord"] = {}
_FROZEN: List[Optional[list]] = [None]


class _StackRecord:
    """One captured stack: the user-code summary line + the full trace."""

    __slots__ = ("summary", "frames")

    def __init__(self, summary: str, frames):
        self.summary = summary
        self.frames = frames

    def format(self) -> str:
        return "".join(traceback.format_list(self.frames))


def debug_mode_enabled() -> bool:
    return _ENABLED


#: reference-name alias (dm_control/mjcf/debugging.py:69)
debug_mode = debug_mode_enabled


def enable_debug_mode(enabled: bool = True) -> None:
    """Turns creation/modification stack tracking on
    (reference --pymjcf_debug)."""
    global _ENABLED
    _ENABLED = enabled
    if not enabled:
        _ORIGINS.clear()
        _ATTR_WRITES.clear()


def disable_debug_mode() -> None:
    enable_debug_mode(False)


def get_full_dump_dir() -> str:
    return _DUMP_DIR


def set_full_dump_dir(dump_path: str) -> None:
    """Directory for full debug dumps (reference
    --pymjcf_debug_full_dump_dir); implies debug mode when set."""
    global _DUMP_DIR
    _DUMP_DIR = dump_path or ""
    if dump_path:
        enable_debug_mode(True)


def _capture() -> _StackRecord:
    if _FROZEN[0] is not None:
        frames = _FROZEN[0]
    else:
        frames = traceback.extract_stack()
        # drop this module + the element machinery from the tail
        while frames and "dm_control_torch/mjcf" in frames[-1].filename.replace(
                os.sep, "/"):
            frames = frames[:-1]
    summary = (f"{frames[-1].filename}:{frames[-1].lineno}"
               if frames else "<unknown>")
    return _StackRecord(summary, list(frames))


@contextlib.contextmanager
def freeze_current_stack_trace():
    """Within this context every tracked write records the stack captured
    at entry — the reference uses this to attribute bulk operations
    (e.g. attach) to their call site rather than to library internals
    (reference debugging.py:144)."""
    prev = _FROZEN[0]
    frames = traceback.extract_stack()[:-2]
    _FROZEN[0] = frames
    try:
        yield
    finally:
        _FROZEN[0] = prev


def record_origin(element) -> None:
    """Called by Element construction when debug mode is on."""
    if not _ENABLED:
        return
    _ORIGINS[id(element)] = _capture()


def record_attribute_write(element, attr: str) -> None:
    """Called by the attribute dict on every write when debug mode is
    on (the reference tracks per-attribute modification stacks)."""
    if not _ENABLED:
        return
    _ATTR_WRITES[(id(element), attr)] = _capture()


def origin_of(element) -> Optional[str]:
    rec = _ORIGINS.get(id(element))
    return rec.summary if rec else None


def attribute_origin(element, attr: str) -> Optional[str]:
    rec = _ATTR_WRITES.get((id(element), attr))
    return rec.summary if rec else None


def element_debug_message(element, attr: Optional[str] = None) -> str:
    """Human-readable provenance for an element (and optionally one of
    its attributes) — appended to compile/validation errors so they
    point at user code (reference _generate_debug_message...)."""
    parts = []
    rec = _ORIGINS.get(id(element))
    if rec:
        parts.append(f"element created at {rec.summary}")
    if attr is not None:
        arec = _ATTR_WRITES.get((id(element), attr))
        if arec:
            parts.append(f"attribute {attr!r} last set at {arec.summary}")
    if not parts:
        return ""
    return " [" + "; ".join(parts) + "]"


def _serialize_annotated(e, indent=0):
    pad = "  " * indent
    lines = []
    origin = origin_of(e)
    if origin:
        lines.append(f"{pad}<!-- created at {origin} -->")
    rendered = []
    for k, v in e.attrib.items():
        if v is None:
            continue
        rendered.append(f'{k}="{v}"')
        aorigin = attribute_origin(e, k)
        if aorigin and aorigin != origin:
            lines.append(f"{pad}<!-- {k} set at {aorigin} -->")
    attrs = " ".join(rendered)
    if e.children:
        lines.append(f"{pad}<{e.tag}{' ' + attrs if attrs else ''}>")
        for c in e.children:
            lines.extend(_serialize_annotated(c, indent + 1))
        lines.append(f"{pad}</{e.tag}>")
    else:
        lines.append(f"{pad}<{e.tag}{' ' + attrs if attrs else ''}/>")
    return lines


def dump_model(root, path: str) -> str:
    """Writes the model XML with `<!-- created at ... -->` and
    `<!-- attr set at ... -->` annotations for every tracked element."""
    text = "\n".join(_serialize_annotated(root)) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return path


def dump_full_debug_info_to_disk(root, dump_dir: Optional[str] = None
                                 ) -> str:
    """Full debug dump (reference debugging.py:272): the annotated model
    XML plus every captured stack trace, to ``dump_dir`` (default: the
    configured full-dump dir, else CWD)."""
    dump_dir = dump_dir or _DUMP_DIR or os.getcwd()
    os.makedirs(dump_dir, exist_ok=True)
    dump_model(root, os.path.join(dump_dir, "model_annotated.xml"))
    stacks_path = os.path.join(dump_dir, "stack_traces.txt")
    with open(stacks_path, "w") as f:
        for e in root.iter():
            rec = _ORIGINS.get(id(e))
            if rec is None:
                continue
            f.write(f"=== element <{e.tag}> {e.path}\n")
            f.write(rec.format() or "  <no frames>\n")
            for (eid, attr), arec in _ATTR_WRITES.items():
                if eid == id(e):
                    f.write(f"--- attribute {attr!r}\n")
                    f.write(arec.format() or "  <no frames>\n")
            f.write("\n")
    return dump_dir
