"""Mesh assets: STL parsing and polyhedron mass properties.

The port's copy of ``dm_control_tpu/mjcf/mesh.py``.

The reference relies on MuJoCo's native mesh compiler (dog.xml loads 162
STL bone meshes whose density-derived masses ARE the dog's mass model;
dm_control/suite/dog.py:1).  Here meshes are compiled host-side into
mass/inertia contributions and centered/principal-axis-aligned frames —
the physics engine never sees triangles (dog's mesh geoms are visual-only:
contype=conaffinity=0), so the device program stays mesh-free.

Volume, centroid and inertia use exact signed-tetrahedron integrals over
the triangle soup (Eberly, "Polyhedral Mass Properties"), matching
MuJoCo's exact/watertight path; a convex-hull fallback matches its legacy
hull-based path when a mesh is not watertight.
"""

from __future__ import annotations

import io
import struct
from typing import Optional, Tuple

import numpy as np


def parse_stl(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """STL bytes → (verts (n,3) float64, faces (m,3) int32).

    Handles binary and ASCII STL.  Vertices are welded exactly (bitwise)
    so faces share indices; mass-property integrals do not require
    welding, but hulls and downstream consumers do.
    """
    if _is_ascii_stl(data):
        tris = _parse_ascii(data)
    else:
        tris = _parse_binary(data)
    # weld identical vertices
    flat = tris.reshape(-1, 3)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    return uniq.astype(np.float64), faces


def _is_ascii_stl(data: bytes) -> bool:
    if len(data) < 84:
        return True
    head = data[:5].lower()
    if head != b"solid":
        return False
    # binary files can also start with 'solid': check the triangle count
    (ntri,) = struct.unpack_from("<I", data, 80)
    return len(data) != 84 + 50 * ntri


def _parse_binary(data: bytes) -> np.ndarray:
    (ntri,) = struct.unpack_from("<I", data, 80)
    rec = np.frombuffer(data, dtype=np.uint8, count=50 * ntri, offset=84)
    rec = rec.reshape(ntri, 50)
    tris = rec[:, 12:48].copy().view("<f4").reshape(ntri, 3, 3)
    return tris.astype(np.float64)


def _parse_ascii(data: bytes) -> np.ndarray:
    verts = []
    for line in io.BytesIO(data):
        line = line.strip()
        if line.startswith(b"vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    tris = np.asarray(verts, np.float64)
    if tris.size == 0 or len(tris) % 3:
        raise ValueError("malformed ASCII STL")
    return tris.reshape(-1, 3, 3)


def mass_properties(verts: np.ndarray, faces: np.ndarray):
    """Exact (volume, centroid, inertia-about-centroid) at unit density.

    Signed-tetrahedron integrals (each face + origin), valid for any
    closed orientable triangle mesh regardless of origin placement.
    """
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    d = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 * signed tet volume
    vol = d.sum() / 6.0
    if abs(vol) < 1e-30:
        raise ValueError("mesh has zero volume")
    com = ((a + b + c) * d[:, None]).sum(0) / (24.0 * vol)

    # inertia: for tet (0,a,b,c), ∫ x_i x_j dV has the closed form
    #   det/120 * (Σ_v x_i^v x_j^v + (Σ_v x_i^v)(Σ_v x_j^v))
    # summed over vertices v ∈ {a,b,c} (the origin contributes zero).
    s = a + b + c
    prod = (np.einsum("ni,nj->nij", a, a) + np.einsum("ni,nj->nij", b, b)
            + np.einsum("ni,nj->nij", c, c) + np.einsum("ni,nj->nij", s, s))
    second = (prod * d[:, None, None]).sum(0) / 120.0  # ∫ x_i x_j dV
    # shift to centroid
    second = second - vol * np.outer(com, com)
    imat = np.trace(second) * np.eye(3) - second
    if vol < 0:  # inward-wound mesh: flip
        vol, imat = -vol, -imat
    return vol, com, imat


def convex_hull_mass_properties(verts: np.ndarray):
    """Mass properties of the convex hull (MuJoCo's legacy path for
    non-watertight meshes)."""
    from scipy.spatial import ConvexHull  # scipy ships in the image

    hull = ConvexHull(verts)
    # reorient hull faces outward w.r.t. the hull centroid
    faces = hull.simplices.astype(np.int32)
    center = verts[np.unique(faces)].mean(0)
    a, b, c = (verts[faces[:, 0]] - center, verts[faces[:, 1]] - center,
               verts[faces[:, 2]] - center)
    flip = np.einsum("ij,ij->i", a, np.cross(b, c)) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return mass_properties(verts, faces)


def _kdop_directions() -> np.ndarray:
    """26 unit directions (box axes + edge + corner bisectors): the
    26-DOP half-space set the rasterizer intersects mesh geoms with."""
    dirs = []
    for x in (-1, 0, 1):
        for y in (-1, 0, 1):
            for z in (-1, 0, 1):
                if x == y == z == 0:
                    continue
                dirs.append([x, y, z])
    d = np.asarray(dirs, np.float64)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


KDOP_DIRECTIONS = _kdop_directions()  # (26, 3)


def kdop_supports(verts: np.ndarray) -> np.ndarray:
    """Support values h_i = max_v d_i . v: the mesh is contained in the
    convex polytope { x : d_i . x <= h_i } (tightest 26-DOP)."""
    return (verts @ KDOP_DIRECTIONS.T).max(axis=0)


class MeshAsset:
    """A compiled mesh: centered, principal-axis-aligned.

    ``pos``/``quat`` give the transform from the ORIGINAL mesh frame to
    the centered frame; geoms referencing the mesh compose with it
    (MuJoCo bakes the same transform into mjModel.mesh_pos/mesh_quat).
    """

    def __init__(self, name: str, verts: np.ndarray, faces: np.ndarray,
                 scale: Optional[np.ndarray] = None):
        if scale is not None:
            verts = verts * np.asarray(scale, np.float64)
            if np.prod(np.sign(scale)) < 0:  # odd reflection flips winding
                faces = faces[:, [0, 2, 1]]
        self.name = name
        try:
            vol, com, imat = mass_properties(verts, faces)
        except ValueError:
            vol, com, imat = convex_hull_mass_properties(verts)
        from dm_control_torch.mjcf.compiler import _mat_to_quat, _principal

        vals, vecs = _principal(imat)
        self.volume = float(vol)
        self.pos = com  # centering translation (original frame)
        self.quat = _mat_to_quat(vecs)  # principal-axis rotation
        # unit-MASS diagonal inertia in the principal frame
        self.inertia_unit_mass = np.maximum(vals, 0.0) / max(vol, 1e-30)
        # vertices in the centered principal frame (for rasterizer/debug)
        self.verts = (verts - com) @ vecs
        self.faces = faces
