"""Ray-cast rasterizer over analytic geom primitives, on the scene's device.

Counterpart of ``dm_control_tpu/rendering/raster.py`` (which replaces the
reference's OpenGL stack, dm_control/_render/ and
dm_control/mujoco/engine.py:593-983).  Every pixel casts a ray from the
camera and intersects the scene's geoms analytically: plane, sphere,
capsule, ellipsoid, cylinder and box exactly; a mesh through its tightest
26-plane convex bound (k-DOP supports from its vertices at compile time,
``mjcf/mesh.py``); a height field as its bounding box.

The geoms are grouped by intersector once per model (``group_geoms``:
the ids, the per-geom size rows, the k-DOP rows); a frame
(``cast_rays``) runs one batched intersector a group on the rays, keeps
the nearest hit of each pixel (the first geom in group order on a tie,
as the JAX package's ``argmin`` over the concatenated groups), and shades
it: the geom's colour, a checker on planes, a headlight, a sky gradient
where nothing is hit, ``clip(rgb * 255 + 0.5)`` truncated to uint8.
Everything is float32 tensor work on the rays' device.  Rays are cast in
chunks so that no group's (geoms, rays) block passes ``_CHUNK_ELEMENTS``:
a 1920 x 1080 frame of a few hundred geoms stays within a few GB.

Outputs mirror dm_control's ``Camera.render`` contract
(engine.py:685-750): uint8 RGB, float32 distance along the ray (the
camera converts it to plane depth), int32 geom id with -1 for background.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dm_control_torch.mjcf.mesh import KDOP_DIRECTIONS
from dm_control_torch.physics.model import GeomType, ObjType

_INF = 1e10
# Headlight shading (MuJoCo's default headlight, ambient .1 and diffuse .4
# on the camera, specular folded into diffuse), as the JAX package's.
_AMBIENT = 0.45
_DIFFUSE = 0.55
_SKY_LOW = (0.08, 0.09, 0.12)
_SKY_HIGH = (0.45, 0.55, 0.70)
#: the largest (geoms x rays x channels) block one intersector call holds
_CHUNK_ELEMENTS = 1 << 24


def _dot(a, b):
    """a . b over the last axis of length 3, summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _normalize(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=1e-12)[..., None]


def _quadratic(a, b, c):
    """Smallest positive root of a t^2 + 2 b t + c = 0, else _INF."""
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    if isinstance(a, torch.Tensor):
        a = torch.where(a == 0.0, 1e-20, a)
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t = torch.where(t0 > 1e-6, t0, t1)
    return torch.where((disc > 0.0) & (t > 1e-6), t, _INF)


# Each intersector works in its geoms' local frames on a bundle of rays:
#   o: (G, 3) ray origins,  d: (G, P, 3) unit directions,  size: (G, S)
# and returns (t, normal): (G, P), (G, P, 3) with t = _INF on a miss.


def _isect_plane(o, d, size):
    # MuJoCo plane: the z = 0 surface of the halfspace z <= 0, infinite
    # where size[0] == 0; visible from the +z side only
    dz = d[..., 2]
    t = torch.where(dz.abs() > 1e-12, -o[:, 2:3] / dz, _INF)
    hit = (t > 1e-6) & (dz < 0.0)
    x = o[:, 0:1] + t * d[..., 0]
    y = o[:, 1:2] + t * d[..., 1]
    finite = size[:, 0:1] > 0.0
    inside = (~finite) | ((x.abs() <= size[:, 0:1])
                          & (y.abs() <= size[:, 1:2]))
    t = torch.where(hit & inside, t, _INF)
    n = torch.zeros_like(d)
    n[..., 2] = 1.0
    return t, n


def _isect_sphere(o, d, size):
    r = size[:, 0:1]
    b = _dot(d, o[:, None, :])
    c = _dot(o, o)[:, None] - r * r
    t = _quadratic(1.0, b, c)
    p = o[:, None, :] + t[..., None] * d
    return t, _normalize(p)


def _isect_ellipsoid(o, d, size):
    s = torch.clamp(size, min=1e-9)
    os_, ds = o / s, d / s[:, None, :]
    a = _dot(ds, ds)
    b = _dot(ds, os_[:, None, :])
    c = _dot(os_, os_)[:, None] - 1.0
    t = _quadratic(a, b, c)
    p = o[:, None, :] + t[..., None] * d
    return t, _normalize(p / (s * s)[:, None, :])


def _side_quadratic(o, d, r):
    """The infinite cylinder |p.xy| = r about the local z axis."""
    a = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    b = d[..., 0] * o[:, 0:1] + d[..., 1] * o[:, 1:2]
    c = (o[:, 0:1] * o[:, 0:1] + o[:, 1:2] * o[:, 1:2]) - r * r
    return _quadratic(a, b, c)


def _isect_capsule(o, d, size):
    r, h = size[:, 0:1], size[:, 1:2]
    t_cyl = _side_quadratic(o, d, r)
    z = o[:, 2:3] + t_cyl * d[..., 2]
    t_cyl = torch.where(z.abs() <= h, t_cyl, _INF)
    # the sphere caps at z = +-h
    lift = torch.zeros_like(o)
    lift[:, 2:3] = h
    caps = []
    for oc in (o - lift, o + lift):
        caps.append(_quadratic(1.0, _dot(d, oc[:, None, :]),
                               _dot(oc, oc)[:, None] - r * r))
    t = torch.minimum(t_cyl, torch.minimum(caps[0], caps[1]))
    p = o[:, None, :] + t[..., None] * d
    n = p.clone()
    n[..., 2] = p[..., 2] - torch.minimum(torch.maximum(p[..., 2], -h), h)
    return t, _normalize(n)


def _isect_cylinder(o, d, size):
    r, h = size[:, 0:1], size[:, 1:2]
    t_side = _side_quadratic(o, d, r)
    z = o[:, 2:3] + t_side * d[..., 2]
    t_side = torch.where(z.abs() <= h, t_side, _INF)
    # the near end disk
    dz = torch.where(d[..., 2].abs() > 1e-12, d[..., 2], 1e-12)
    sign = torch.where(o[:, 2:3] > 0, 1.0, -1.0).to(o.dtype)
    t_cap = (sign * h - o[:, 2:3]) / dz
    xc = o[:, 0:1] + t_cap * d[..., 0]
    yc = o[:, 1:2] + t_cap * d[..., 1]
    t_cap = torch.where((t_cap > 1e-6) & (xc * xc + yc * yc <= r * r),
                        t_cap, _INF)
    side = t_side < t_cap
    t = torch.minimum(t_side, t_cap)
    p = o[:, None, :] + t[..., None] * d
    n_side = p.clone()
    n_side[..., 2] = 0.0
    n_side = _normalize(n_side)
    n_cap = torch.zeros_like(p)
    n_cap[..., 2] = torch.sign(p[..., 2])
    return t, torch.where(side[..., None], n_side, n_cap)


def _isect_box(o, d, size):
    dsafe = torch.where(d.abs() > 1e-12, d, 1e-12)
    t1 = ((-size - o)[:, None, :]) / dsafe
    t2 = ((size - o)[:, None, :]) / dsafe
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    t_near, axis = tmin.max(dim=-1)
    t_far = tmax.amin(dim=-1)
    hit = (t_near <= t_far) & (t_far > 1e-6)
    t = torch.where(t_near > 1e-6, t_near, t_far)
    t = torch.where(hit, t, _INF)
    # the normal: the axis of the entry slab, against the ray
    d_axis = torch.gather(d, -1, axis[..., None])
    n = torch.zeros_like(d).scatter_(-1, axis[..., None], -torch.sign(d_axis))
    return t, n


def _isect_kdop(o, d, sup):
    """Convex 26-DOP (a mesh's stand-in): the ray against the intersection
    of the half-spaces n_i . x <= sup_i, n_i the rows of
    ``KDOP_DIRECTIONS``.  Exact for the polytope."""
    N = torch.as_tensor(KDOP_DIRECTIONS, dtype=o.dtype, device=o.device)
    no = (o[:, 0:1] * N[:, 0] + o[:, 1:2] * N[:, 1]
          + o[:, 2:3] * N[:, 2])                                 # (G, K)
    nd = (d[..., 0:1] * N[:, 0] + d[..., 1:2] * N[:, 1]
          + d[..., 2:3] * N[:, 2])                               # (G, P, K)
    safe = torch.where(nd.abs() > 1e-12, nd, 1e-12)
    tt = (sup - no)[:, None, :] / safe
    entering = nd < 0.0
    # a parallel ray outside any half-space never hits
    outside_parallel = ((nd.abs() <= 1e-12)
                        & (no > sup)[:, None, :]).any(dim=-1)
    t_in, plane = torch.where(entering, tt, -_INF).max(dim=-1)
    t_out = torch.where(entering, _INF, tt).amin(dim=-1)
    hit = (t_in <= t_out) & (t_out > 1e-6) & ~outside_parallel
    t = torch.where(t_in > 1e-6, t_in, t_out)
    t = torch.where(hit, t, _INF)
    # the normal: the entering plane that set t_in
    return t, N[plane]


_ISECT = {
    int(GeomType.PLANE): _isect_plane,
    int(GeomType.SPHERE): _isect_sphere,
    int(GeomType.CAPSULE): _isect_capsule,
    int(GeomType.ELLIPSOID): _isect_ellipsoid,
    int(GeomType.CYLINDER): _isect_cylinder,
    int(GeomType.BOX): _isect_box,
}


@dataclasses.dataclass(frozen=True)
class Group:
    """The geoms of one type, intersected by one batched call."""

    isect: Callable
    ids: torch.Tensor   # (Gk,) long: the geoms' ids
    size: torch.Tensor  # (Gk, S) float32: what ``isect`` takes as size
    is_plane: bool
    width: int          # channels of the intersector's widest block


def group_geoms(geom_types, geom_size, geom_rbound, mesh_as_sphere=True,
                geom_kdop=None) -> Tuple[Group, ...]:
    """The scene's geoms grouped by type in ascending type order, as the
    JAX package's ``render_rays`` groups them, each with its intersector
    and size rows (float32, on ``geom_size``'s device): a mesh takes its
    k-DOP row where ``geom_kdop`` is given, else its bounding sphere
    (``mesh_as_sphere``) or box; a height field its box (the caller puts
    the box's size in ``geom_size``).  Static for a model: built once."""
    device = geom_size.device
    by_type = {}
    for gid, gt in enumerate(geom_types):
        by_type.setdefault(int(gt), []).append(gid)
    groups = []
    for gt, ids in sorted(by_type.items()):
        idx = torch.as_tensor(ids, dtype=torch.long, device=device)
        width = 3
        if gt == int(GeomType.MESH) and geom_kdop is not None:
            isect, size = _isect_kdop, geom_kdop[idx]
            width = len(KDOP_DIRECTIONS)
        elif gt == int(GeomType.MESH) and mesh_as_sphere:
            isect = _isect_sphere
            size = geom_rbound[idx][:, None].expand(-1, 3)
        elif gt in (int(GeomType.MESH), int(GeomType.HFIELD)):
            isect, size = _isect_box, geom_size[idx]
        else:
            isect, size = _ISECT[gt], geom_size[idx]
        groups.append(Group(isect=isect, ids=idx,
                            size=size.to(torch.float32).contiguous(),
                            is_plane=gt == int(GeomType.PLANE),
                            width=width))
    return tuple(groups)


def _to_local(origin, dirs, pos, mat):
    """World rays in each geom's frame: R^T (o - pos) and R^T d."""
    rel = origin[None, :] - pos                                   # (G, 3)
    ol = (rel[:, 0:1] * mat[:, 0, :] + rel[:, 1:2] * mat[:, 1, :]
          + rel[:, 2:3] * mat[:, 2, :])
    dl = (dirs[None, :, 0:1] * mat[:, None, 0, :]
          + dirs[None, :, 1:2] * mat[:, None, 1, :]
          + dirs[None, :, 2:3] * mat[:, None, 2, :])              # (G, P, 3)
    return ol, dl


def _cast_chunk(origin, dirs, geom_pos, geom_mat, rgba, groups):
    P = dirs.shape[0]
    best_t = torch.full((P,), _INF, dtype=dirs.dtype, device=dirs.device)
    best_n = torch.zeros_like(dirs)
    best_id = torch.zeros((P,), dtype=torch.long, device=dirs.device)
    best_plane = torch.zeros((P,), dtype=torch.bool, device=dirs.device)
    for g in groups:
        mat = geom_mat[g.ids]
        ol, dl = _to_local(origin, dirs, geom_pos[g.ids], mat)
        t, n_local = g.isect(ol, dl, g.size)
        # invisible geoms (alpha == 0) never win
        t = torch.where(rgba[g.ids, 3:4] > 0.0, t, _INF)
        t_min, win = t.min(dim=0)                    # the first on a tie
        n = torch.gather(n_local, 0, win[None, :, None].expand(1, P, 3))[0]
        m = mat[win]                                 # (P, 3, 3)
        n = (n[:, 0:1] * m[:, :, 0] + n[:, 1:2] * m[:, :, 1]
             + n[:, 2:3] * m[:, :, 2])               # back to the world
        better = t_min < best_t
        best_t = torch.where(better, t_min, best_t)
        best_n = torch.where(better[:, None], n, best_n)
        best_id = torch.where(better, g.ids[win], best_id)
        best_plane = (best_plane | better) if g.is_plane else (
            best_plane & ~better)
    hit = best_t < _INF * 0.5
    segid = torch.where(hit, best_id, -1).to(torch.int32)
    color = rgba[best_id, :3]
    # the checker on planes (a stand-in for the grid texture of the
    # reference's floors), keyed on the hit's world x and y
    px = origin[0] + best_t * dirs[:, 0]
    py = origin[1] + best_t * dirs[:, 1]
    checker = (torch.floor(px * 2.0) + torch.floor(py * 2.0)) % 2.0
    color = torch.where((best_plane & hit)[:, None],
                        color * (0.82 + 0.18 * checker[:, None]), color)
    # the headlight: light travels along the ray
    lam = torch.clamp(-_dot(best_n, dirs), min=0.0)
    rgb = color * (_AMBIENT + _DIFFUSE * lam)[:, None]
    # the sky: a vertical gradient keyed on the ray's z
    up = torch.clamp(dirs[:, 2] * 0.5 + 0.5, 0.0, 1.0)[:, None]
    low = torch.tensor([_SKY_LOW], dtype=dirs.dtype, device=dirs.device)
    high = torch.tensor([_SKY_HIGH], dtype=dirs.dtype, device=dirs.device)
    rgb = torch.where(hit[:, None], rgb, low * (1 - up) + high * up)
    rgb_u8 = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
    zdist = torch.where(hit, best_t, 0.0)
    return rgb_u8, zdist, segid


def cast_rays(origin, dirs, geom_pos, geom_mat, geom_rgba,
              groups: Tuple[Group, ...]):
    """Casts rays into a scene grouped by ``group_geoms``; returns
    (rgb (P, 3) uint8, zdist (P,) float32, segid (P,) int32).

    origin (3,) and dirs (P, 3) unit world-frame rays; geom_pos (G, 3),
    geom_mat (G, 3, 3), geom_rgba (G, 4): all float32 on one device.
    zdist is the distance along the ray (0 on a miss); segid the winning
    geom's id, -1 where nothing is hit."""
    P = dirs.shape[0]
    widest = max((len(g.ids) * g.width for g in groups), default=1)
    chunk = max(1, _CHUNK_ELEMENTS // widest)
    if chunk >= P:
        return _cast_chunk(origin, dirs, geom_pos, geom_mat, geom_rgba,
                           groups)
    rgb = torch.empty((P, 3), dtype=torch.uint8, device=dirs.device)
    zdist = torch.empty((P,), dtype=dirs.dtype, device=dirs.device)
    segid = torch.empty((P,), dtype=torch.int32, device=dirs.device)
    for lo in range(0, P, chunk):
        hi = min(P, lo + chunk)
        rgb[lo:hi], zdist[lo:hi], segid[lo:hi] = _cast_chunk(
            origin, dirs[lo:hi], geom_pos, geom_mat, geom_rgba, groups)
    return rgb, zdist, segid


def render_rays(origin, dirs, geom_pos, geom_mat, geom_size, geom_rbound,
                geom_rgba, geom_types, mesh_as_sphere=True,
                geom_kdop: Optional[torch.Tensor] = None):
    """The JAX package's ``render_rays`` signature: groups the geoms, then
    ``cast_rays``.  Every array float32 on one device; ``geom_types`` a
    sequence of ints."""
    groups = group_geoms(geom_types, geom_size, geom_rbound,
                         mesh_as_sphere=mesh_as_sphere, geom_kdop=geom_kdop)
    return cast_rays(origin, dirs, geom_pos, geom_mat, geom_rgba, groups)


def segmentation_image(segid, height, width):
    """(P,) geom ids -> (H, W, 2) int32 numpy [objid, objtype], -1 for
    background; ``segid`` on any device (one copy of it to the host)."""
    seg = segid.cpu().numpy().reshape(height, width)
    out = np.full((height, width, 2), -1, np.int32)
    out[..., 0] = seg
    out[..., 1] = np.where(seg >= 0, int(ObjType.GEOM), -1)
    return out
