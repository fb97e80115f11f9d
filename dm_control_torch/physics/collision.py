"""Collision detection: static broadphase + batched primitive narrowphase.

Counterpart of ``dm_control_tpu/physics/collision.py``.  The candidate
pairs are fixed when the model is compiled; here they are grouped by
collider type, and each group runs as one batched computation over
(B, pairs).  Every collider emits a fixed number of rows per pair; rows
beyond their margin stay in the arrays with zero force in the solver, so
shapes never depend on the state.

Ported colliders: plane-sphere, plane-capsule, sphere-sphere,
sphere-capsule and capsule-capsule.  A model with any other pair raises
``NotImplementedError``, unless its contacts or all its constraints are
disabled: then no pair is collided at all.  (The JAX package tests only
the CONTACT bit and still collides a model whose CONSTRAINT bit is set,
such as acrobot with its plane-cylinder pair; nothing reads those
contacts, since no constraint row and no force comes of them.)

Contact normals point from geom1 into geom2; frame rows are
[normal, tangent1, tangent2].
"""

from __future__ import annotations

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


_DISPATCH = {
    (GeomType.PLANE, GeomType.SPHERE): (plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (plane_capsule, 2),
    (GeomType.SPHERE, GeomType.SPHERE): (sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (sphere_capsule, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (capsule_capsule, 1),
}


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
        if key not in _DISPATCH:
            raise NotImplementedError(
                f"collision {key[0].name}-{key[1].name} (geoms {g1},{g2}) "
                f"is not ported yet (ROADMAP A1: quadruped and the domains "
                f"after it)")
        p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
        if p1 != p2:
            condim = m.geom_condim[g1 if p1 > p2 else g2]
        else:
            condim = max(m.geom_condim[g1], m.geom_condim[g2])
        groups.setdefault(key, []).append((g1, g2, int(condim)))
    return [(key, _DISPATCH[key][1], pairs) for key, pairs in groups.items()]


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
        fn = _DISPATCH[key][0]
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
