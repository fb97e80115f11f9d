"""MuJoCo ``.skn`` skin file parsing/serialization.

The port's copy of ``dm_control_tpu/mjcf/skin.py`` (it holds no
PyTorch: the element tree and numpy only).

Reference: dm_control/mjcf/skin.py:35-100 — the binary layout is
``<iiii`` (nvertex, ntexcoord, nface, nbone) followed by f4 vertex/
texcoord arrays, i4 faces, then per-bone records (40-byte body name,
bindpos f4x3, bindquat f4x4, i4 count, i4 ids, f4 weights).

Skins are rendering-only in this framework (the physics never reads
them); the parser exists so reference assets round-trip through
export_with_assets and so renderers can consume the skinned surface.
"""

from __future__ import annotations

import struct
from typing import Callable, List, NamedTuple

import numpy as np

MAX_BODY_NAME_LENGTH = 40


class Bone(NamedTuple):
    body: Callable  # lazy body resolver (name -> element)
    bindpos: np.ndarray
    bindquat: np.ndarray
    vertex_ids: np.ndarray
    vertex_weights: np.ndarray


class Skin(NamedTuple):
    vertices: np.ndarray
    texcoords: np.ndarray
    faces: np.ndarray
    bones: List[Bone]


def parse(contents: bytes, body_getter: Callable[[str], object]) -> Skin:
    """Parses a ``.skn`` payload; ``body_getter(name)`` resolves bone
    bodies lazily (evaluated when ``bone.body()`` is called)."""
    buf = memoryview(contents)
    nvertex, ntexcoord, nface, nbone = struct.unpack_from("<iiii", buf, 0)
    off = 16

    def take(dtype, count, shape=None):
        nonlocal off
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=off)
        off += arr.nbytes
        return arr.reshape(shape) if shape else arr

    vertices = take("<f4", 3 * nvertex, (-1, 3))
    texcoords = take("<f4", 2 * ntexcoord, (-1, 2))
    faces = take("<i4", 3 * nface, (-1, 3))
    bones = []
    for _ in range(nbone):
        raw = bytes(buf[off:off + MAX_BODY_NAME_LENGTH])
        off += MAX_BODY_NAME_LENGTH
        name = raw.split(b"\0", 1)[0].decode()
        bindpos = take("<f4", 3).astype(float)
        bindquat = take("<f4", 4).astype(float)
        (count,) = struct.unpack_from("<i", buf, off)
        off += 4
        ids = take("<i4", count)
        weights = take("<f4", count)
        bones.append(Bone(
            body=(lambda n=name: body_getter(n)),
            bindpos=bindpos, bindquat=bindquat,
            vertex_ids=ids, vertex_weights=weights))
    return Skin(vertices=vertices, texcoords=texcoords, faces=faces,
                bones=bones)


def serialize(skin: Skin) -> bytes:
    """Inverse of :func:`parse` (reference skin.py:68-100)."""
    parts = [struct.pack("<iiii", len(skin.vertices), len(skin.texcoords),
                         len(skin.faces), len(skin.bones))]
    parts.append(np.asarray(skin.vertices, "<f4").tobytes())
    parts.append(np.asarray(skin.texcoords, "<f4").tobytes())
    parts.append(np.asarray(skin.faces, "<i4").tobytes())
    for bone in skin.bones:
        body = bone.body() if callable(bone.body) else bone.body
        name = body if isinstance(body, str) else body.get("name")
        parts.append(name.encode().ljust(MAX_BODY_NAME_LENGTH, b"\0"))
        parts.append(np.asarray(bone.bindpos, "<f4").tobytes())
        parts.append(np.asarray(bone.bindquat, "<f4").tobytes())
        if len(bone.vertex_ids) != len(bone.vertex_weights):
            raise ValueError("vertex_ids/vertex_weights length mismatch")
        parts.append(struct.pack("<i", len(bone.vertex_ids)))
        parts.append(np.asarray(bone.vertex_ids, "<i4").tobytes())
        parts.append(np.asarray(bone.vertex_weights, "<f4").tobytes())
    return b"".join(parts)
