"""Collision detection: static broadphase + batched primitive narrowphase.

Counterpart of ``dm_control_tpu/physics/collision.py``.  The candidate
pairs are fixed when the model is compiled; here they are grouped by
collider type, and each group runs as one batched computation over
(B, pairs).  Every collider emits a fixed number of rows per pair; rows
beyond their margin stay in the arrays with zero force in the solver, so
shapes never depend on the state.

Every collider of the JAX package's dispatch table is ported: a plane
against a sphere, capsule, cylinder, ellipsoid or box; sphere-sphere,
sphere-capsule, sphere-box, capsule-capsule, capsule-box, the ellipsoid
against a sphere, capsule, ellipsoid or box, the cylinder against a
sphere, capsule, cylinder, ellipsoid or box, box-box; and a heightfield
against a sphere, capsule, cylinder, ellipsoid or box.  Several are the
JAX package's approximations of MuJoCo's colliders and are ported as they
are (box-box marks a corner outside the reference face with an infinite
distance, and the solver carries that row with no force).  A model with a
pair the JAX package has no collider for either (a mesh, say) raises
``NotImplementedError``, unless its contacts or all its constraints are
disabled: then no pair is collided at all.  (The JAX package tests only
the CONTACT bit and still collides a model whose CONSTRAINT bit is set,
such as acrobot with its plane-cylinder pair; nothing reads those
contacts, since no constraint row and no force comes of them.)

Contact normals point from geom1 into geom2; frame rows are
[normal, tangent1, tangent2].
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dm_control_torch.physics import mathx as mx
from dm_control_torch.physics.model import (
    Contact, Data, DisableBit, GeomType, Model,
)

_MINVAL = 1e-15


def _make_frame(n):
    """[n, t1, t2] (..., 3, 3) from unit normals, as mju_makeFrame."""
    e_y = n.new_tensor([0.0, 1.0, 0.0])
    e_z = n.new_tensor([0.0, 0.0, 1.0])
    a = torch.where((torch.abs(n[..., 1]) < 0.5).unsqueeze(-1), e_y, e_z)
    t1 = a - n * mx.dot(n, a).unsqueeze(-1)
    t1 = t1 / torch.clamp(mx.norm(t1), min=_MINVAL).unsqueeze(-1)
    return torch.stack([n, t1, mx.cross(n, t1)], dim=-2)


# Each collider takes (p1, m1, s1, p2, m2, s2) with leading dims (B, P)
# (sizes (P, 3)) and returns dist (B, P, R), pos (B, P, R, 3) and
# frame (B, P, R, 3, 3) for a fixed row count R.


def plane_sphere(p1, m1, s1, p2, m2, s2):
    n = m1[..., :, 2]
    r = s2[..., 0]
    dist = mx.dot(n, p2 - p1) - r
    pos = p2 - n * (r + 0.5 * dist).unsqueeze(-1)
    return (dist.unsqueeze(-1), pos.unsqueeze(-2),
            _make_frame(n).unsqueeze(-3))


def plane_capsule(p1, m1, s1, p2, m2, s2):
    """Two cap contacts; tangent1 is the capsule axis projected onto the
    plane (mjc_PlaneCapsule's frame)."""
    n = m1[..., :, 2]
    r, hl = s2[..., 0], s2[..., 1]
    axis = m2[..., :, 2]
    t1 = axis - n * mx.dot(n, axis).unsqueeze(-1)
    t1n = mx.norm(t1).unsqueeze(-1)
    fallback = _make_frame(n)[..., 1, :]
    t1 = torch.where(t1n < 1e-10, fallback,
                     t1 / torch.clamp(t1n, min=_MINVAL))
    frame = torch.stack([n, t1, mx.cross(n, t1)], dim=-2)
    hla = hl.unsqueeze(-1) * axis
    caps = p2.unsqueeze(-2) + torch.stack([hla, -hla], dim=-2)  # (.., 2, 3)
    dist = mx.dot(caps, n.unsqueeze(-2)) - mx.dot(n, p1).unsqueeze(-1) \
        - r.unsqueeze(-1)
    pos = caps - n.unsqueeze(-2) * (r.unsqueeze(-1) + 0.5 * dist
                                    ).unsqueeze(-1)
    return dist, pos, torch.stack([frame, frame], dim=-3)


def plane_cylinder(p1, m1, s1, p2, m2, s2):
    """Four contacts: the deepest rim point of each cap and two spread
    points on the lower cap (approximates mjc_PlaneCylinder)."""
    n = m1[..., :, 2]
    r, hl = s2[..., 0:1], s2[..., 1:2]
    axis = m2[..., :, 2]
    n_ax = mx.dot(n, axis).unsqueeze(-1)
    proj = n - axis * n_ax
    pn = mx.norm(proj).unsqueeze(-1)
    radial = torch.where(pn < 1e-8, m2[..., :, 0],
                         -proj / torch.clamp(pn, min=_MINVAL))
    t = mx.cross(axis, radial)
    lower = torch.where(n_ax < 0, 1.0, -1.0)
    c_lo = p2 + lower * hl * axis
    cos, sin = math.cos(2.0944), math.sin(2.0944)
    pts = torch.stack([
        p2 + hl * axis + r * radial,
        p2 - hl * axis + r * radial,
        c_lo + r * (radial * cos + t * sin),
        c_lo + r * (radial * cos - t * sin)], dim=-2)  # (.., 4, 3)
    n4 = n.unsqueeze(-2)
    dist = mx.dot(pts, n4) - mx.dot(n, p1).unsqueeze(-1)
    pos = pts - n4 * 0.5 * dist.unsqueeze(-1)
    frame = _make_frame(n).unsqueeze(-3)
    return dist, pos, frame.expand(*dist.shape, 3, 3)


def plane_ellipsoid(p1, m1, s1, p2, m2, s2):
    n = m1[..., :, 2]
    nloc = mx.mat_t_vec(m2, n)
    denom = torch.sqrt(torch.sum((s2 * nloc) ** 2, -1, keepdim=True))
    sp = p2 + mx.mat_vec(m2, -(s2 ** 2) * nloc
                         / torch.clamp(denom, min=_MINVAL))
    dist = mx.dot(n, sp - p1)
    pos = sp - n * 0.5 * dist.unsqueeze(-1)
    return (dist.unsqueeze(-1), pos.unsqueeze(-2),
            _make_frame(n).unsqueeze(-3))


#: the eight corners of a box, as signs of its half-sizes, x slowest
_CORNER_SIGNS = ((-1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
                 (-1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (1.0, -1.0, 1.0),
                 (1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


def _box_corners(p, mat, size):
    """World corners (..., 8, 3) of boxes at ``p`` (..., 3) turned by
    ``mat`` (..., 3, 3) with half-sizes ``size`` (..., 3)."""
    local = size.new_tensor(_CORNER_SIGNS) * size.unsqueeze(-2)
    return p.unsqueeze(-2) + mx.mat_vec(mat.unsqueeze(-3), local)


def _take(x, i):
    """x[..., i] for an index tensor ``i`` of x's leading shape."""
    return torch.gather(x, -1, i.unsqueeze(-1)).squeeze(-1)


def plane_box(p1, m1, s1, p2, m2, s2):
    """The four lowest corners; the sort is stable, so of a box lying flat
    (four corners at one height) the first four in corner order come."""
    n = m1[..., :, 2]
    corners = _box_corners(p2, m2, s2)
    h = mx.dot(corners, n.unsqueeze(-2)) - mx.dot(n, p1).unsqueeze(-1)
    order = torch.argsort(h, dim=-1, stable=True)[..., :4]
    dist = torch.gather(h, -1, order)
    low = torch.gather(corners, -2, order.unsqueeze(-1).expand(
        *order.shape, 3))
    pos = low - n.unsqueeze(-2) * 0.5 * dist.unsqueeze(-1)
    frame = _make_frame(n).unsqueeze(-3)
    return dist, pos, frame.expand(*dist.shape, 3, 3)


def _sphere_pair(c1, r1, c2, r2):
    diff = c2 - c1
    ln = mx.norm(diff)
    n = diff / torch.clamp(ln, min=_MINVAL).unsqueeze(-1)
    dist = ln - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist).unsqueeze(-1)
    return (dist.unsqueeze(-1), pos.unsqueeze(-2),
            _make_frame(n).unsqueeze(-3))


def sphere_sphere(p1, m1, s1, p2, m2, s2):
    return _sphere_pair(p1, s1[..., 0], p2, s2[..., 0])


def _closest_on_seg(p, a, b):
    ab = b - a
    t = mx.dot(p - a, ab) / torch.clamp(mx.dot(ab, ab), min=_MINVAL)
    return a + torch.clamp(t, 0.0, 1.0).unsqueeze(-1) * ab


def sphere_capsule(p1, m1, s1, p2, m2, s2):
    half = s2[..., 1:2] * m2[..., :, 2]
    c = _closest_on_seg(p1, p2 - half, p2 + half)
    return _sphere_pair(p1, s1[..., 0], c, s2[..., 0])


def capsule_capsule(p1, m1, s1, p2, m2, s2):
    a1 = p1 - s1[..., 1:2] * m1[..., :, 2]
    d1 = 2 * s1[..., 1:2] * m1[..., :, 2]
    a2 = p2 - s2[..., 1:2] * m2[..., :, 2]
    d2 = 2 * s2[..., 1:2] * m2[..., :, 2]
    r = a1 - a2
    a = mx.dot(d1, d1)
    e = mx.dot(d2, d2)
    f = mx.dot(d2, r)
    c = mx.dot(d1, r)
    b = mx.dot(d1, d2)
    denom = a * e - b * b
    zero = torch.zeros_like(denom)
    s = torch.where(denom > _MINVAL, torch.clamp(
        (b * f - c * e) / torch.clamp(denom, min=_MINVAL), 0, 1), zero)
    t = (b * s + f) / torch.clamp(e, min=_MINVAL)
    s = torch.where(t < 0, torch.clamp(-c / torch.clamp(a, min=_MINVAL),
                                       0, 1), s)
    s = torch.where(t > 1, torch.clamp((b - c) / torch.clamp(a, min=_MINVAL),
                                       0, 1), s)
    t = torch.clamp(t, 0.0, 1.0)
    return _sphere_pair(a1 + d1 * s.unsqueeze(-1), s1[..., 0],
                        a2 + d2 * t.unsqueeze(-1), s2[..., 0])


def _sphere_box(center, radius, p2, m2, s2):
    """(dist, pos, frame) of spheres against boxes, no row axis.  A centre
    inside the box leaves through the face of least depth (the first of
    equal ones)."""
    c = mx.mat_t_vec(m2, center - p2)
    clamped = torch.maximum(torch.minimum(c, s2), -s2)
    inside = torch.all(torch.abs(c) < s2, dim=-1)
    diff = c - clamped
    ln = mx.norm(diff)
    n_out = diff / torch.clamp(ln, min=_MINVAL).unsqueeze(-1)
    dist_out = ln - radius
    depth = s2 - torch.abs(c)
    ax = torch.argmin(depth, dim=-1)
    sign = torch.sign(_take(c, ax) + 1e-30)
    n_in = torch.nn.functional.one_hot(ax, 3).to(c.dtype) \
        * sign.unsqueeze(-1)
    depth_ax = _take(depth, ax)
    dist_in = -(depth_ax + radius)
    i3 = inside.unsqueeze(-1)
    surf = torch.where(i3, c + n_in * depth_ax.unsqueeze(-1), clamped)
    n_loc = torch.where(i3, n_in, n_out)
    dist = torch.where(inside, dist_in, dist_out)
    n_box = mx.mat_vec(m2, n_loc)
    pos = p2 + mx.mat_vec(m2, surf) - (0.5 * dist).unsqueeze(-1) * n_box
    return dist, pos, _make_frame(-n_box)


def sphere_box(p1, m1, s1, p2, m2, s2):
    dist, pos, frame = _sphere_box(p1, s1[..., 0], p2, m2, s2)
    return dist.unsqueeze(-1), pos.unsqueeze(-2), frame.unsqueeze(-3)


def capsule_box(p1, m1, s1, p2, m2, s2):
    """Approximation: sphere-box at the segment's two ends and at its point
    closest to the box's centre (3 rows)."""
    half = s1[..., 1:2] * m1[..., :, 2]
    a, b = p1 - half, p1 + half
    mid = _closest_on_seg(p2, a, b)
    rows = [_sphere_box(c, s1[..., 0], p2, m2, s2) for c in (a, b, mid)]
    return (torch.stack([r[0] for r in rows], dim=-1),
            torch.stack([r[1] for r in rows], dim=-2),
            torch.stack([r[2] for r in rows], dim=-3))


def cylinder_box(p1, m1, s1, p2, m2, s2):
    """The cylinder as the capsule of its radius and half-length."""
    return capsule_box(p1, m1, s1, p2, m2, s2)


def cylinder_cylinder(p1, m1, s1, p2, m2, s2):
    """Approximation: the two cylinders as capsules."""
    return capsule_capsule(p1, m1, s1, p2, m2, s2)


def _matmul3(a, b):
    """a @ b of (..., 3, 3) matrices, each entry summed left to right."""
    return sum(a[..., :, k, None] * b[..., None, k, :] for k in range(3))


def _matvec3(a, v):
    """a @ v of (..., 3, 3) and (..., 3), summed left to right."""
    return sum(a[..., :, k] * v[..., k, None] for k in range(3))


def box_box(p1, m1, s1, p2, m2, s2):
    """Approximation of mjc_BoxBox: separating-axis test over the six face
    axes; the face of least overlap is the reference, the other box's
    eight corners are the rows, and a corner outside the reference face's
    footprint gets an infinite distance.  Edge-edge contacts fall back to
    the best face axis.  Ties go to the first axis, as in the JAX
    package."""
    m1t = m1.transpose(-1, -2)
    m2t = m2.transpose(-1, -2)
    r = _matmul3(m1t, m2)
    t = _matvec3(m1t, p2 - p1)
    absr = torch.abs(r) + 1e-9
    sep1 = torch.abs(t) - (s1 + _matvec3(absr, s2))
    t2 = _matvec3(r.transpose(-1, -2), t)
    sep2 = torch.abs(t2) - (s2 + _matvec3(absr.transpose(-1, -2), s1))
    best = torch.argmax(torch.cat([sep1, sep2], dim=-1), dim=-1)
    use1 = best < 3
    axis = best % 3
    axes_w = torch.cat([m1t, m2t], dim=-2)  # rows: the six face axes
    n = torch.gather(axes_w, -2, best[..., None, None].expand(
        *best.shape, 1, 3)).squeeze(-2)
    sign_ref = torch.where(use1, torch.sign(_take(t, axis) + 1e-30),
                           torch.sign(_take(t2, axis) + 1e-30))
    n = n * sign_ref.unsqueeze(-1)

    u3 = use1.unsqueeze(-1)
    u33 = u3.unsqueeze(-1)
    corners = torch.where(u33, _box_corners(p2, m2, s2),
                          _box_corners(p1, m1, s1))
    ref_p = torch.where(u3, p1, p2)
    ref_m = torch.where(u33, m1, m2)
    ref_s = torch.where(u3, s1, s2)
    n_into = torch.where(u3, n, -n)  # out of the reference box
    n_loc = mx.mat_t_vec(ref_m, n_into)
    face_center = ref_p + n_into * torch.abs(
        mx.dot(n_loc, ref_s)).unsqueeze(-1)
    dists = mx.dot(corners - face_center.unsqueeze(-2), n_into.unsqueeze(-2))
    local = mx.mat_t_vec(ref_m.unsqueeze(-3), corners - ref_p.unsqueeze(-2))
    face_ax = torch.argmax(torch.abs(n_loc), dim=-1)
    lat_ax = torch.stack([(face_ax + 1) % 3, (face_ax + 2) % 3], dim=-1)
    lat = torch.gather(local, -1, lat_ax.unsqueeze(-2).expand(
        *local.shape[:-1], 2))
    lat_s = torch.gather(ref_s, -1, lat_ax)
    in_footprint = torch.all(torch.abs(lat) <= lat_s.unsqueeze(-2) + 1e-6,
                             dim=-1)
    dist = torch.where(in_footprint, dists, torch.full_like(dists,
                                                            float("inf")))
    pos = corners - n_into.unsqueeze(-2) * 0.5 * dists.unsqueeze(-1)
    frame = _make_frame(n).unsqueeze(-3)
    return dist, pos, frame.expand(*dist.shape, 3, 3)


def _ellipsoid_closest(c, size):
    """The point of an origin-centred, axis-aligned ellipsoid's surface
    closest to ``c``: Newton on the Lagrange multiplier, twelve steps
    whatever the data (the JAX package's count)."""
    a2 = size ** 2
    a4 = a2 * a2
    lam = torch.zeros_like(c[..., :1])
    one = torch.ones_like(c)
    tiny = torch.full_like(lam, _MINVAL)
    for _ in range(12):
        w = torch.addcdiv(one, lam, a2)  # 1 + lam / a2
        xx = (c / w) ** 2
        phi = torch.sum(xx / a2, -1, keepdim=True) - 1.0
        dphi = -2.0 * torch.sum(xx / (a4 * w), -1, keepdim=True)
        dphi = torch.where(torch.abs(dphi) < _MINVAL, tiny, dphi)
        lam = torch.addcdiv(lam, phi, dphi, value=-1.0)  # lam - phi / dphi
    return c / (1.0 + lam / a2)


def _ellipsoid_contact(c, r1, p2, m2, s2):
    """The contact of a sphere of radius ``r1`` centred at ``c`` (in the
    ellipsoid's frame) with the ellipsoid; normal from the sphere into
    it."""
    x = _ellipsoid_closest(c, s2)
    n_loc = x / torch.clamp(s2 ** 2, min=_MINVAL)
    n_loc = n_loc / torch.clamp(mx.norm(n_loc), min=_MINVAL).unsqueeze(-1)
    inside = torch.sum((c / s2) ** 2, -1) < 1.0
    sgn = torch.where(inside, -1.0, 1.0)
    dist = sgn * mx.norm(c - x) - r1
    n_world = -sgn.unsqueeze(-1) * mx.mat_vec(m2, n_loc)
    pos = p2 + mx.mat_vec(m2, x) - (0.5 * dist).unsqueeze(-1) * (-n_world)
    return (dist.unsqueeze(-1), pos.unsqueeze(-2),
            _make_frame(n_world).unsqueeze(-3))


def _surface_pair(x1w, x2w, p1, m1, s1):
    """The contact between two surface points: ``x1w`` of geom 1 (an
    ellipsoid at ``p1``, ``m1`` with semi-axes ``s1``) and ``x2w`` of
    geom 2; overlapping where x2w lies inside the ellipsoid."""
    diff = x2w - x1w
    ln = mx.norm(diff)
    v = mx.mat_t_vec(m1, x2w - p1)
    inside = torch.sum((v / s1) ** 2, -1) < 1.0
    sgn = torch.where(inside, -1.0, 1.0)
    n = sgn.unsqueeze(-1) * diff / torch.clamp(ln, min=_MINVAL).unsqueeze(-1)
    return ((sgn * ln).unsqueeze(-1), (0.5 * (x1w + x2w)).unsqueeze(-2),
            _make_frame(n).unsqueeze(-3))


def ellipsoid_ellipsoid(p1, m1, s1, p2, m2, s2):
    """Six rounds of alternating closest-point projection between the two
    surfaces."""
    x1w = p1
    for _ in range(6):
        x2w = p2 + mx.mat_vec(m2, _ellipsoid_closest(
            mx.mat_t_vec(m2, x1w - p2), s2))
        x1w = p1 + mx.mat_vec(m1, _ellipsoid_closest(
            mx.mat_t_vec(m1, x2w - p1), s1))
    return _surface_pair(x1w, x2w, p1, m1, s1)


def _closest_on_box(c, size):
    """The point of an origin-centred box's surface closest to ``c``:
    clamped onto it, or pushed out through the face of least depth from
    inside."""
    clamped = torch.maximum(torch.minimum(c, size), -size)
    inside = torch.all(torch.abs(c) < size, dim=-1, keepdim=True)
    ax = torch.argmin(size - torch.abs(c), dim=-1, keepdim=True)
    face = torch.sign(torch.gather(c, -1, ax) + 1e-30) \
        * torch.gather(size.expand_as(c), -1, ax)
    pushed = clamped.scatter(-1, ax, face)
    return torch.where(inside, pushed, clamped)


def ellipsoid_box(p1, m1, s1, p2, m2, s2):
    """Six rounds of alternating projection between the ellipsoid's and
    the box's surfaces."""
    x1w = p1
    for _ in range(6):
        x2w = p2 + mx.mat_vec(m2, _closest_on_box(
            mx.mat_t_vec(m2, x1w - p2), s2))
        x1w = p1 + mx.mat_vec(m1, _ellipsoid_closest(
            mx.mat_t_vec(m1, x2w - p1), s1))
    return _surface_pair(x1w, x2w, p1, m1, s1)


def sphere_ellipsoid(p1, m1, s1, p2, m2, s2):
    return _ellipsoid_contact(mx.mat_t_vec(m2, p1 - p2), s1[..., 0], p2, m2,
                              s2)


def capsule_ellipsoid(p1, m1, s1, p2, m2, s2):
    """Six fixed-point rounds between the closest point of the capsule's
    segment and the closest point of the ellipsoid."""
    half = s1[..., 1:2] * m1[..., :, 2]
    a = mx.mat_t_vec(m2, p1 - half - p2)
    b = mx.mat_t_vec(m2, p1 + half - p2)
    c = 0.5 * (a + b)
    for _ in range(6):
        c = _closest_on_seg(_ellipsoid_closest(c, s2), a, b)
    return _ellipsoid_contact(c, s1[..., 0], p2, m2, s2)


def capsule_cylinder(p1, m1, s1, p2, m2, s2):
    """Approximation: the cylinder's side acts as a capsule of its radius
    and half-length, with the flat cap where the capsule's closest point
    lies beyond it and over its disk."""
    r1, h1 = s1[..., 0], s1[..., 1:2]
    r2, h2 = s2[..., 0], s2[..., 1]
    a1 = p1 - h1 * m1[..., :, 2]
    b1 = p1 + h1 * m1[..., :, 2]
    axis2 = m2[..., :, 2]
    a2 = p2 - h2.unsqueeze(-1) * axis2
    b2 = p2 + h2.unsqueeze(-1) * axis2
    d1v = b1 - a1
    d2v = b2 - a2
    rvec = a1 - a2
    a = mx.dot(d1v, d1v)
    e = mx.dot(d2v, d2v)
    f = mx.dot(d2v, rvec)
    cc = mx.dot(d1v, rvec)
    b = mx.dot(d1v, d2v)
    denom = a * e - b * b
    s = torch.where(denom > _MINVAL, torch.clamp(
        (b * f - cc * e) / torch.clamp(denom, min=_MINVAL), 0, 1),
        torch.zeros_like(denom))
    t = (b * s + f) / torch.clamp(e, min=_MINVAL)
    s = torch.where(t < 0, torch.clamp(-cc / torch.clamp(a, min=_MINVAL),
                                       0, 1), s)
    s = torch.where(t > 1, torch.clamp(
        (b - cc) / torch.clamp(a, min=_MINVAL), 0, 1), s)
    t = torch.clamp(t, 0.0, 1.0)
    pc = a1 + d1v * s.unsqueeze(-1)  # capsule point
    pz = a2 + d2v * t.unsqueeze(-1)  # cylinder axis point
    # side contact
    radial = pc - pz
    axial_comp = mx.dot(radial, axis2)
    radial_perp = radial - axial_comp.unsqueeze(-1) * axis2
    rp_norm = mx.norm(radial_perp)
    n_side = -radial_perp / torch.clamp(rp_norm, min=_MINVAL).unsqueeze(-1)
    dist_side = rp_norm - r2 - r1
    pos_side = pc + n_side * (r1 + 0.5 * dist_side).unsqueeze(-1)
    # cap contact: the capsule's point beyond the cap plane
    cap_sign = torch.sign(axial_comp + 1e-30)
    cap_axis = cap_sign.unsqueeze(-1) * axis2
    cap_center = p2 + (cap_sign * h2).unsqueeze(-1) * axis2
    drop = pc - cap_center
    in_disk_n = mx.norm(drop - mx.dot(drop, axis2).unsqueeze(-1) * axis2)
    dist_cap = mx.dot(drop, cap_axis) - r1
    pos_cap = pc - cap_axis * (r1 + 0.5 * dist_cap).unsqueeze(-1)
    use_cap = (torch.abs(axial_comp) > h2) & (in_disk_n < r2)
    use3 = use_cap.unsqueeze(-1)
    dist = torch.where(use_cap, dist_cap, dist_side)
    pos = torch.where(use3, pos_cap, pos_side)
    n = torch.where(use3, -cap_axis, n_side)
    return (dist.unsqueeze(-1), pos.unsqueeze(-2),
            _make_frame(n).unsqueeze(-3))


def sphere_cylinder(p1, m1, s1, p2, m2, s2):
    """A sphere is a capsule of no length."""
    zero = torch.zeros_like(s1[..., 0])
    return capsule_cylinder(p1, m1, torch.stack([s1[..., 0], zero, zero], -1),
                            p2, m2, s2)


def ellipsoid_cylinder(p1, m1, s1, p2, m2, s2):
    """The cylinder as a capsule through capsule-ellipsoid with the two
    geoms swapped; the normal turned back to point from the ellipsoid
    into the cylinder."""
    dist, pos, frame = capsule_ellipsoid(p2, m2, s2, p1, m1, s1)
    return dist, pos, _make_frame(-frame[..., 0, :])


# Heightfield colliders: the terrain's height is read bilinearly; the other
# geom touches it at a fixed set of sample points.  The elevation data is a
# model leaf that an episode may override (quadruped's escape), (nrow, ncol)
# or one terrain per environment, (B, nrow, ncol).


def _hf_surface(data, size, p_local):
    """Height (B, ...) and unit normal (B, ..., 3) of the terrain under
    the local points ``p_local`` (B, ..., 3)."""
    nrow, ncol = data.shape[-2:]
    fx = torch.clamp((p_local[..., 0] / size[0] + 1.0) * 0.5 * (ncol - 1),
                     0.0, ncol - 1.001)
    fy = torch.clamp((p_local[..., 1] / size[1] + 1.0) * 0.5 * (nrow - 1),
                     0.0, nrow - 1.001)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    at = y0.long() * ncol + x0.long()  # cell (y0, x0), flattened
    cells = torch.stack([at, at + 1, at + ncol, at + ncol + 1], dim=-1)
    if data.dim() == 3:  # one terrain per environment
        h = data.reshape(data.shape[0], -1).gather(
            1, cells.reshape(cells.shape[0], -1)).reshape(cells.shape)
    else:
        h = data.reshape(-1)[cells]
    h00, h01, h10, h11 = h.unbind(-1)
    height = ((1 - ty) * ((1 - tx) * h00 + tx * h01)
              + ty * ((1 - tx) * h10 + tx * h11)) * size[2]
    cell_dx = size[0] * 2.0 / (ncol - 1)
    cell_dy = size[1] * 2.0 / (nrow - 1)
    dhdx = (((1 - ty) * (h01 - h00) + ty * (h11 - h10)) * size[2]) / cell_dx
    dhdy = (((1 - tx) * (h10 - h00) + tx * (h11 - h01)) * size[2]) / cell_dy
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(height)], dim=-1)
    return height, n / mx.norm(n).unsqueeze(-1)


def _hf_point_contacts(data, size, m1, p1, pts_world, radius):
    """Contacts of the world points ``pts_world`` (B, ..., 3), each a
    sphere of ``radius`` (broadcasting over the points), with the terrain
    at ``p1``, ``m1`` (broadcasting likewise)."""
    loc = mx.mat_t_vec(m1, pts_world - p1)
    h, n_loc = _hf_surface(data, size, loc)
    surf_loc = torch.stack([loc[..., 0], loc[..., 1], h], dim=-1)
    dist = mx.dot(loc - surf_loc, n_loc) - radius
    n_world = mx.mat_vec(m1, n_loc)
    pos = pts_world - n_world * (radius + 0.5 * dist).unsqueeze(-1)
    return dist, pos, _make_frame(n_world)


def _hf_sphere_samples(p2, m2, s2):
    return p2.unsqueeze(-2), s2[..., 0]


def _hf_capsule_samples(p2, m2, s2):
    """The two cap centres; a cylinder is sampled as the capsule of its
    radius and half-length."""
    half = s2[..., 1:2] * m2[..., :, 2]
    return torch.stack([p2 + half, p2 - half], dim=-2), s2[..., 0]


def _hf_ellipsoid_samples(p2, m2, s2):
    """The bottom pole (the terrain's z is up), with the minor axis as the
    contact radius."""
    r = torch.min(s2, dim=-1).values
    drop = torch.max(s2, dim=-1).values - r
    e_z = p2.new_tensor([0.0, 0.0, 1.0])
    return (p2 - e_z * drop.unsqueeze(-1)).unsqueeze(-2), r


def _hf_box_samples(p2, m2, s2):
    """The eight corners, as points."""
    return _box_corners(p2, m2, s2), torch.zeros_like(s2[..., 0])


_HFIELD_SAMPLES = {
    GeomType.SPHERE: (_hf_sphere_samples, 1),
    GeomType.CAPSULE: (_hf_capsule_samples, 2),
    GeomType.CYLINDER: (_hf_capsule_samples, 2),
    GeomType.ELLIPSOID: (_hf_ellipsoid_samples, 1),
    GeomType.BOX: (_hf_box_samples, 8),
}


def _hfield_collider(data, size, sample_fn, p1, m1, s1, p2, m2, s2):
    """(B, P) pairs of the terrain with a geom sampled at R points."""
    pts, radius = sample_fn(p2, m2, s2)  # (B, P, R, 3), (P,)
    return _hf_point_contacts(data, size, m1.unsqueeze(2), p1.unsqueeze(2),
                              pts, radius.unsqueeze(-1))


_DISPATCH = {
    (GeomType.PLANE, GeomType.SPHERE): (plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (plane_capsule, 2),
    (GeomType.PLANE, GeomType.CYLINDER): (plane_cylinder, 4),
    (GeomType.PLANE, GeomType.ELLIPSOID): (plane_ellipsoid, 1),
    (GeomType.PLANE, GeomType.BOX): (plane_box, 4),
    (GeomType.SPHERE, GeomType.SPHERE): (sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (sphere_capsule, 1),
    (GeomType.SPHERE, GeomType.BOX): (sphere_box, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (capsule_capsule, 1),
    (GeomType.CAPSULE, GeomType.BOX): (capsule_box, 3),
    (GeomType.SPHERE, GeomType.ELLIPSOID): (sphere_ellipsoid, 1),
    (GeomType.CAPSULE, GeomType.ELLIPSOID): (capsule_ellipsoid, 1),
    (GeomType.CAPSULE, GeomType.CYLINDER): (capsule_cylinder, 1),
    (GeomType.CYLINDER, GeomType.CYLINDER): (cylinder_cylinder, 1),
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID): (ellipsoid_ellipsoid, 1),
    (GeomType.ELLIPSOID, GeomType.BOX): (ellipsoid_box, 1),
    (GeomType.SPHERE, GeomType.CYLINDER): (sphere_cylinder, 1),
    (GeomType.ELLIPSOID, GeomType.CYLINDER): (ellipsoid_cylinder, 1),
    (GeomType.CYLINDER, GeomType.BOX): (cylinder_box, 3),
    (GeomType.BOX, GeomType.BOX): (box_box, 8),
}


def _resolve_collider(m: Model, key):
    """(collider, rows a pair) for a pair of geom types, or (None, 0); a
    heightfield's collider closes over the model's terrain."""
    if key[0] == GeomType.HFIELD and key[1] in _HFIELD_SAMPLES:
        sample_fn, nrows = _HFIELD_SAMPLES[key[1]]
        return functools.partial(_hfield_collider, m.hfield_data,
                                 m.hfield_size[0], sample_fn), nrows
    return _DISPATCH.get(key, (None, 0))


def contact_groups(m: Model):
    """Static grouping of candidate pairs by collider type: a list of
    (key, nrows, pairs) with pairs [(g1, g2, condim)]; the row order is
    group-major, pair-major, row-major, as in the JAX package."""
    if m.opt is not None and m.opt.disableflags & (
            DisableBit.CONTACT | DisableBit.CONSTRAINT):
        return []
    groups = {}
    for g1, g2 in m.collision_pairs:
        key = (GeomType(m.geom_type[g1]), GeomType(m.geom_type[g2]))
        if _resolve_collider(m, key)[0] is None:
            raise NotImplementedError(
                f"collision {key[0].name}-{key[1].name} (geoms {g1},{g2}) "
                f"is not supported: the JAX package has no collider for "
                f"it either")
        p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
        if p1 != p2:
            condim = m.geom_condim[g1 if p1 > p2 else g2]
        else:
            condim = max(m.geom_condim[g1], m.geom_condim[g2])
        groups.setdefault(key, []).append((g1, g2, int(condim)))
    return [(key, _resolve_collider(m, key)[1], pairs)
            for key, pairs in groups.items()]


def contact_rows_static(m: Model):
    """Flat static row structure: (dims, geom1s, geom2s) tuples."""
    dims, g1s, g2s = [], [], []
    for _, nrows, pairs in contact_groups(m):
        for g1, g2, condim in pairs:
            dims += [condim] * nrows
            g1s += [g1] * nrows
            g2s += [g2] * nrows
    return tuple(dims), tuple(g1s), tuple(g2s)


def _pair_params(m: Model, pairs):
    """mj_contactParam over a pair group: per-pair friction (5), solref,
    solimp and includemargin, (P, ...)."""
    g1 = m.idx([p[0] for p in pairs])
    g2 = m.idx([p[1] for p in pairs])
    pr1 = np.array([m.geom_priority[p[0]] for p in pairs])
    pr2 = np.array([m.geom_priority[p[1]] for p in pairs])
    dev = m.device
    use1 = torch.tensor(pr1 > pr2, device=dev)[:, None]
    use2 = torch.tensor(pr2 > pr1, device=dev)[:, None]
    f1, f2 = m.geom_friction[g1], m.geom_friction[g2]
    sr1, sr2 = m.geom_solref[g1], m.geom_solref[g2]
    si1, si2 = m.geom_solimp[g1], m.geom_solimp[g2]
    s1 = torch.clamp(m.geom_solmix[g1], min=_MINVAL)[:, None]
    s2 = torch.clamp(m.geom_solmix[g2], min=_MINVAL)[:, None]
    w1, w2 = s1 / (s1 + s2), s2 / (s1 + s2)
    friction = torch.where(use1, f1, torch.where(use2, f2,
                                                 torch.maximum(f1, f2)))
    solref_mix = torch.where((sr1[:, :1] > 0) & (sr2[:, :1] > 0),
                             w1 * sr1 + w2 * sr2, torch.minimum(sr1, sr2))
    solref = torch.where(use1, sr1, torch.where(use2, sr2, solref_mix))
    solimp = torch.where(use1, si1, torch.where(use2, si2,
                                                w1 * si1 + w2 * si2))
    margin = torch.maximum(m.geom_margin[g1], m.geom_margin[g2])
    gap = torch.maximum(m.geom_gap[g1], m.geom_gap[g2])
    mu = friction
    friction5 = torch.stack([mu[:, 0], mu[:, 0], mu[:, 1], mu[:, 2],
                             mu[:, 2]], dim=-1)
    return friction5, solref, solimp, margin - gap


def _contact_params(m: Model):
    """Concatenated per-row (friction, solref, solimp, includemargin)."""
    parts = [[], [], [], []]
    for _, nrows, pairs in contact_groups(m):
        for acc, x in zip(parts, _pair_params(m, pairs)):
            acc.append(torch.repeat_interleave(x, nrows, dim=0))
    return tuple(torch.cat(p) for p in parts)


def empty_contact(m: Model, batch: int, dtype) -> Contact:
    """Contacts with the model's static row structure, all inactive."""
    dims, g1s, g2s = contact_rows_static(m)
    n = len(dims)
    dev = m.device

    def rows(*vals):
        return torch.tensor(vals, dtype=dtype, device=dev).expand(
            batch, n, len(vals))

    return Contact(
        dist=torch.full((batch, n), float("inf"), dtype=dtype, device=dev),
        pos=torch.zeros(batch, n, 3, dtype=dtype, device=dev),
        frame=torch.eye(3, dtype=dtype, device=dev).expand(batch, n, 3, 3),
        includemargin=torch.zeros(batch, n, dtype=dtype, device=dev),
        friction=rows(1.0, 1.0, 1.0, 1.0, 1.0),
        solref=rows(0.02, 1.0), solimp=rows(0.9, 0.95, 0.001, 0.5, 2.0),
        dim=dims, geom1=g1s, geom2=g2s)


def collision(m: Model, d: Data) -> Data:
    """Batched narrowphase over the static pair groups."""
    B = d.qpos.shape[0]
    groups = m.cached("contact_groups", lambda: contact_groups(m))
    if not groups:
        return d.replace(contact=empty_contact(m, B, d.qpos.dtype))
    dims, g1all, g2all = m.cached("contact_rows",
                                  lambda: contact_rows_static(m))
    dists, poss, frames = [], [], []
    for key, nrows, pairs in groups:
        fn = _resolve_collider(m, key)[0]
        g1 = m.idx([p[0] for p in pairs])
        g2 = m.idx([p[1] for p in pairs])
        dist, pos, frame = fn(d.geom_xpos[:, g1], d.geom_xmat[:, g1],
                              m.geom_size[g1], d.geom_xpos[:, g2],
                              d.geom_xmat[:, g2], m.geom_size[g2])
        dists.append(dist.reshape(B, -1))
        poss.append(pos.reshape(B, -1, 3))
        frames.append(frame.reshape(B, -1, 3, 3))
    fri, sr, si, inc = m.cached("contact_params", lambda: _contact_params(m))
    n = len(dims)
    contact = Contact(
        dist=torch.cat(dists, dim=1), pos=torch.cat(poss, dim=1),
        frame=torch.cat(frames, dim=1),
        includemargin=inc.expand(B, n), friction=fri.expand(B, n, 5),
        solref=sr.expand(B, n, 2), solimp=si.expand(B, n, 5),
        dim=dims, geom1=g1all, geom2=g2all)
    return d.replace(contact=contact)
