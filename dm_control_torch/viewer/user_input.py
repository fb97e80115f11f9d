"""Input mapping: device events -> viewer actions (counterpart of
``dm_control_tpu/viewer/user_input.py``).

Behavioral contract shared with the reference viewer
(dm_control/viewer/user_input.py:146-320): callbacks bound to key
combinations, with three binding flavors — plain (fire on press),
``Exclusive`` (callback(True) on press, callback(False) on release, and
while held all other bindings are suppressed), ``Range`` (one callback
receiving the index of whichever combination fired) and ``DoubleClick``.
Plane/z-axis mouse-drag callbacks receive pixel translations.

This implementation is device-agnostic: any GUI backend (the bundled web
canvas, a notebook widget, a native window) forwards its raw events to
``key_event`` / ``mouse_move`` / ``scroll`` / ``double_click``.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

# key codes: printable keys use their character; specials use names
KEY_SPACE = " "
KEY_ESCAPE = "Escape"
KEY_ENTER = "Enter"
KEY_BACKSPACE = "Backspace"
KEY_TAB = "Tab"
KEY_UP = "ArrowUp"
KEY_DOWN = "ArrowDown"
KEY_LEFT = "ArrowLeft"
KEY_RIGHT = "ArrowRight"
KEY_F1 = "F1"
KEY_F5 = "F5"
MOUSE_LEFT = "MouseLeft"
MOUSE_RIGHT = "MouseRight"
MOUSE_MIDDLE = "MouseMiddle"

MOD_NONE = 0
MOD_SHIFT = 1
MOD_CONTROL = 2
MOD_ALT = 4


class Exclusive(collections.namedtuple("Exclusive", "combination")):
    """Press/release binding that suppresses others while held."""


class DoubleClick(collections.namedtuple("DoubleClick", "combination")):
    """Fires on double clicks of the combination."""


class Range(collections.namedtuple("Range", "collection")):
    """One callback for a list of combinations; receives the index."""


def _combo(binding) -> Tuple[int, str]:
    """Normalizes a binding spec to (modifiers, key)."""
    if isinstance(binding, tuple) and len(binding) == 2 \
            and isinstance(binding[0], int):
        return (binding[0], binding[1])
    return (MOD_NONE, binding)


class InputMap:
    """Routes raw device events to bound callbacks."""

    def __init__(self):
        self.clear_bindings()

    def clear_bindings(self):
        self._press: Dict[Tuple[int, str], List[Callable]] = {}
        self._exclusive: Dict[Tuple[int, str], Callable] = {}
        self._double: Dict[Tuple[int, str], List[Callable]] = {}
        self._plane: List[Callable] = []
        self._zaxis: List[Callable] = []
        self._active_exclusive: Optional[Tuple[Tuple[int, str],
                                               Callable]] = None

    # -- binding --------------------------------------------------------------

    def bind(self, callback: Callable, binding) -> None:
        if isinstance(binding, Exclusive):
            self._exclusive[_combo(binding.combination)] = callback
        elif isinstance(binding, DoubleClick):
            self._double.setdefault(
                _combo(binding.combination), []).append(callback)
        elif isinstance(binding, Range):
            for idx, combo in enumerate(binding.collection):
                def indexed(cb=callback, i=idx):
                    cb(i)
                self._press.setdefault(_combo(combo), []).append(indexed)
        else:
            self._press.setdefault(_combo(binding), []).append(callback)

    def bind_plane(self, callback: Callable) -> None:
        """callback(position, translation) for in-plane mouse drags."""
        self._plane.append(callback)

    def bind_z_axis(self, callback: Callable) -> None:
        """callback(translation_y) for z-axis mouse drags (scroll or
        vertical drag in z mode)."""
        self._zaxis.append(callback)

    # -- device events ---------------------------------------------------------

    def key_event(self, key: str, pressed: bool,
                  modifiers: int = MOD_NONE) -> None:
        combo = (modifiers, key)
        if self._active_exclusive is not None:
            active_combo, cb = self._active_exclusive
            # release of the exclusive key (any modifier state) ends it
            if not pressed and key == active_combo[1]:
                cb(False)
                self._active_exclusive = None
            return  # everything else suppressed while exclusive is held
        if pressed and combo in self._exclusive:
            cb = self._exclusive[combo]
            self._active_exclusive = (combo, cb)
            cb(True)
            return
        if pressed:
            for cb in self._press.get(combo, ()):
                cb()

    def double_click(self, key: str, modifiers: int = MOD_NONE) -> None:
        if self._active_exclusive is not None:
            return
        for cb in self._double.get((modifiers, key), ()):
            cb()

    def mouse_move(self, position, translation) -> None:
        for cb in self._plane:
            cb(position, translation)

    def scroll(self, value: float) -> None:
        for cb in self._zaxis:
            cb(value)
