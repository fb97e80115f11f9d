"""The port's cylinder, ellipsoid, box and heightfield colliders and its
cubic resize against the JAX package's functions, in float64 on the CPU.

Poses and sizes are numpy draws from a seed.  Each collider runs batched
over (B, P) pairs in the port and under ``jax.vmap`` over the same B * P
pairs in the JAX package; dist, pos and frame agree within 1e-12 (the same
expressions on both sides; they differ by the order of sums of three
terms).  The pairs are placed touching, apart and, for the ellipsoid and
the box, with the other geom's centre inside it.  The two colliders that
project alternately between two surfaces (ellipsoid-ellipsoid and
ellipsoid-box) take their normal from the difference of two surface
points; where the points nearly meet (|dist| < 1e-2) rounding alone turns
that normal, so their frames are held to 1e-12 elsewhere only.  The ties
random poses do not meet have tests of their own: a box lying flat on a
plane (four corners at one height) and box-box with the reference face on
either box.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu.physics import collision as jcoll
from dm_control_torch.physics import collision as tcoll
from dm_control_torch.suite.quadruped import cubic_resize_matrix

jax.config.update("jax_enable_x64", True)

B, P = 3, 4
ATOL = 1e-12
COLLIDERS = ("plane_cylinder", "plane_ellipsoid", "sphere_ellipsoid",
             "capsule_ellipsoid", "capsule_cylinder", "sphere_cylinder",
             "plane_box", "sphere_box", "capsule_box", "cylinder_box",
             "cylinder_cylinder", "ellipsoid_ellipsoid", "ellipsoid_box",
             "ellipsoid_cylinder", "box_box")
#: distance between the two centres, in units of the sizes' scale
PLACEMENTS = {"touching": 0.25, "apart": 1.5, "inside": 0.02}


def _rotations(rng, shape):
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = (q[..., i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _pairs(seed, spread):
    """Poses (B, P, ...) and sizes (P, 3) of two geoms ``spread`` apart."""
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-0.5, 0.5, (B, P, 3))
    direction = rng.normal(size=(B, P, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    p2 = p1 + spread * direction * rng.uniform(0.8, 1.2, (B, P, 1))
    s1 = rng.uniform(0.1, 0.3, (P, 3))
    s2 = rng.uniform(0.1, 0.3, (P, 3))
    return (p1, _rotations(rng, (B, P)), s1, p2, _rotations(rng, (B, P)), s2)


def _both(name, args):
    """(port, JAX) outputs of a collider on the same (B, P) pairs."""
    p1, m1, s1, p2, m2, s2 = args
    got = getattr(tcoll, name)(*(torch.as_tensor(a) for a in args))
    flat = [jnp.asarray(a.reshape((B * P,) + a.shape[2:]))
            for a in (p1, m1, np.broadcast_to(s1, (B, P, 3)), p2, m2,
                      np.broadcast_to(s2, (B, P, 3)))]
    want = jax.vmap(getattr(jcoll, name))(*flat)
    return got, [np.asarray(w).reshape((B, P) + w.shape[1:]) for w in want]


#: only the ellipsoid and the box have a branch for a centre inside them
CASES = [(name, placement) for name in COLLIDERS for placement in PLACEMENTS
         if placement != "inside" or "ellipsoid" in name or "box" in name]


#: the normal is the direction between two surface points
_PROJECTIONS = ("ellipsoid_ellipsoid", "ellipsoid_box")


@pytest.mark.parametrize("name,placement", CASES)
def test_collider_matches_jax(name, placement):
    args = _pairs(sum(map(ord, name)), PLACEMENTS[placement])
    got, want = _both(name, args)
    conditioned = np.ones(got[0].shape, bool)
    if name in _PROJECTIONS:
        conditioned = np.abs(got[0].numpy()) >= 1e-2
        assert conditioned.any()
    for g, w, what in zip(got, want, ("dist", "pos", "frame")):
        assert g.shape == w.shape, what
        g = g.numpy()
        if what == "frame":
            g, w = g[conditioned], w[conditioned]
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=what)
    dist = got[0].numpy()
    if placement == "apart" and name.endswith(("_ellipsoid", "_box")) \
            and not name.startswith(("plane", "box")):
        assert (dist > 0).all()
    if placement == "inside" and name in ("sphere_ellipsoid", "sphere_box"):
        assert (dist < 0).all()  # the centre lies inside the other geom
    if placement == "touching":
        assert (dist < 0).any()
    if name == "box_box":  # corners outside the reference face: no contact
        assert np.isinf(dist).any() and np.isfinite(dist).any()


def test_cylinder_flat_on_the_plane_and_capsule_over_the_cap():
    """The branches random poses do not meet: a cylinder whose axis is the
    plane's normal (the radial direction falls back to its x axis), and a
    capsule above a cylinder's cap by more than the cylinder's half-length
    (the JAX package's condition for the cap contact)."""
    eye = np.broadcast_to(np.eye(3), (B, P, 3, 3)).copy()
    rng = np.random.default_rng(5)
    p1 = np.zeros((B, P, 3))
    p2 = rng.uniform(-0.2, 0.2, (B, P, 3)) + np.array([0.0, 0.0, 0.25])
    s = rng.uniform(0.1, 0.3, (P, 3))
    got, want = _both("plane_cylinder", (p1, eye, s, p2, eye, s))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    # capsule lying across the top cap, its closest point over the disk
    lying = eye[..., [2, 1, 0]] * np.array([1.0, 1.0, -1.0])
    cyl = np.tile(np.array([0.3, 0.2, 0.0]), (P, 1))
    cap = np.tile(np.array([0.05, 0.1, 0.0]), (P, 1))
    pc = np.zeros((B, P, 3)) + np.array([0.05, 0.02, 0.45]) \
        + rng.uniform(-0.01, 0.01, (B, P, 3))
    got, want = _both("capsule_cylinder",
                      (pc, lying, cap, np.zeros((B, P, 3)), eye, cyl))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    # the normal is the cylinder's axis, pointing down into it
    np.testing.assert_allclose(got[2][..., 0, 0, :].numpy(),
                               np.broadcast_to([0.0, 0.0, -1.0], (B, P, 3)),
                               atol=ATOL)
    np.testing.assert_allclose(got[0][..., 0].numpy(),
                               pc[..., 2] - 0.2 - 0.05, atol=ATOL)


def test_box_flat_on_the_plane_takes_the_first_four_corners():
    """Four corners at exactly one height: the stable sort keeps corner
    order on both sides, and the lowest corners are the bottom face, 1 cm
    into the plane, each contact half-way between corner and plane."""
    rng = np.random.default_rng(9)
    eye = np.broadcast_to(np.eye(3), (B, P, 3, 3)).copy()
    angle = rng.uniform(0, 6, (B, P))
    turn = np.zeros((B, P, 3, 3))  # about z only: still lying flat
    turn[..., 0, 0], turn[..., 0, 1] = np.cos(angle), -np.sin(angle)
    turn[..., 1, 0], turn[..., 1, 1] = np.sin(angle), np.cos(angle)
    turn[..., 2, 2] = 1.0
    size = rng.uniform(0.05, 0.2, (P, 3))
    p2 = np.zeros((B, P, 3))
    p2[..., 2] = size[:, 2] - 0.01
    for m2 in (eye, turn):
        got, want = _both("plane_box", (np.zeros((B, P, 3)), eye, size, p2,
                                        m2, size))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got[0].numpy(), -0.01, atol=1e-12)
        np.testing.assert_allclose(got[1][..., 2].numpy(), -0.005,
                                   atol=1e-12)


@pytest.mark.parametrize("reference", ["box1", "box2"])
def test_box_box_reference_face_on_either_box(reference):
    """A small box pressed into a large one's top face: the large box's
    face is the reference whichever of the two it is, and the small box's
    four lower corners are the contacts (the upper four lie above the
    face, the other box's corners outside the small face)."""
    rng = np.random.default_rng(13)
    big = np.tile([0.3, 0.3, 0.1], (P, 1))
    small = np.tile([0.05, 0.04, 0.03], (P, 1))
    eye = np.broadcast_to(np.eye(3), (B, P, 3, 3)).copy()
    tilt = _rotations(rng, (B, P)) * 0.02 + eye  # nearly aligned
    tilt, _ = np.linalg.qr(tilt)
    tilt *= np.sign(np.einsum("...ii->...i", tilt))[..., None, :]
    p_big = rng.uniform(-0.1, 0.1, (B, P, 3))
    p_small = p_big + np.array([0.0, 0.0, 0.1 + 0.03 - 0.005]) \
        + rng.uniform(-0.02, 0.02, (B, P, 3)) * [1, 1, 0]
    args = (p_big, eye, big, p_small, tilt, small) if reference == "box1" \
        else (p_small, tilt, small, p_big, eye, big)
    got, want = _both("box_box", args)
    for g, w, what in zip(got, want, ("dist", "pos", "frame")):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=what)
    dist = got[0].numpy()
    assert ((dist < 0).sum(-1) == 4).all()  # the small box's lower face
    normal = got[2][..., 0, 0, :].numpy()  # from geom 1 into geom 2
    up = 1.0 if reference == "box1" else -1.0
    np.testing.assert_allclose(
        normal, np.broadcast_to([0, 0, up], normal.shape), atol=1e-12)


# -- heightfield --------------------------------------------------------------


def _field(seed, batched):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 1.0, ((B,) if batched else ()) + (17, 17))
    size = np.array([3.0, 2.0, 0.7, 0.1])
    return rng, data, size


@pytest.mark.parametrize("batched", [False, True],
                         ids=["one_terrain", "terrain_per_environment"])
def test_hf_surface_and_point_contacts_match_jax(batched):
    rng, data, size = _field(3, batched)
    K = 6
    pts = rng.uniform(-1.0, 1.0, (B, K, 3)) * np.array([3.5, 2.5, 0.5])
    pts[0, 0, :2] = [-3.0, 2.0]  # on the field's corner, and beyond it
    p1 = rng.uniform(-0.3, 0.3, (B, K, 3))
    m1 = _rotations(rng, (B,))[:, None].repeat(K, 1)
    radius = rng.uniform(0.02, 0.2, K)

    def jsurface(data, p):
        return jax.vmap(lambda q: jcoll._hf_surface(data, jnp.asarray(size),
                                                    q))(p)

    def jcontacts(data, m1, p1, pts):
        return jax.vmap(lambda m, p, q, r: jcoll._hf_point_contacts(
            data, jnp.asarray(size), m, p, q[None], r))(
                m1, p1, pts, jnp.asarray(radius))

    in_axes = (0 if batched else None, 0)
    h, n = jax.vmap(jsurface, in_axes=in_axes)(jnp.asarray(data),
                                               jnp.asarray(pts))
    th, tn = tcoll._hf_surface(torch.as_tensor(data), torch.as_tensor(size),
                               torch.as_tensor(pts))
    np.testing.assert_allclose(th.numpy(), np.asarray(h), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(n), rtol=0, atol=ATOL)

    want = jax.vmap(jcontacts, in_axes=in_axes + (0, 0))(
        jnp.asarray(data), jnp.asarray(m1), jnp.asarray(p1),
        jnp.asarray(pts))
    got = tcoll._hf_point_contacts(
        torch.as_tensor(data), torch.as_tensor(size), torch.as_tensor(m1),
        torch.as_tensor(p1), torch.as_tensor(pts), torch.as_tensor(radius))
    for g, w, what in zip(got, want, ("dist", "pos", "frame")):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=what)
    if batched:  # each environment read its own terrain
        other = tcoll._hf_surface(torch.as_tensor(data[[1, 2, 0]]),
                                  torch.as_tensor(size),
                                  torch.as_tensor(pts))[0]
        assert float((other - th).abs().max()) > 1e-3


@pytest.mark.parametrize("geom", ["sphere", "capsule", "cylinder",
                                  "ellipsoid", "box"])
def test_hfield_collider_matches_jax(geom):
    from dm_control_tpu.physics.model import GeomType as JGeomType
    from dm_control_torch.physics.model import GeomType

    rng, data, size = _field(11, True)
    p1, m1, s1, p2, m2, s2 = _pairs(23, 0.3)
    m1 = np.broadcast_to(np.eye(3), m1.shape).copy()
    jsample, nrows = jcoll._HFIELD_SAMPLES[JGeomType[geom.upper()]]
    tsample, trows = tcoll._HFIELD_SAMPLES[GeomType[geom.upper()]]
    assert nrows == trows

    def jone(data, p1, m1, p2, m2):
        fn = jcoll.make_hfield_collider(data, jnp.asarray(size), jsample)
        return jax.vmap(fn)(p1, m1, jnp.asarray(s1), p2, m2, jnp.asarray(s2))

    want = jax.vmap(jone)(*(jnp.asarray(a) for a in (data, p1, m1, p2, m2)))
    got = tcoll._hfield_collider(
        torch.as_tensor(data), torch.as_tensor(size), tsample,
        *(torch.as_tensor(a) for a in (p1, m1, s1, p2, m2, s2)))
    for g, w, what in zip(got, want, ("dist", "pos", "frame")):
        assert g.shape == np.asarray(w).shape == (B, P, nrows) + g.shape[3:]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=what)


# -- the terrain's cubic resize -----------------------------------------------


@pytest.mark.parametrize("n_in,n_out", [(30, 201), (5, 17), (7, 7)])
def test_cubic_resize_matches_jax_image_resize(n_in, n_out):
    bumps = np.random.default_rng(n_in).uniform(0.15, 1.0, (n_in, n_in))
    want = np.asarray(jax.image.resize(jnp.asarray(bumps), (n_out, n_out),
                                       method="cubic"))
    w = cubic_resize_matrix(n_in, n_out)
    assert w.shape == (n_out, n_in)
    np.testing.assert_allclose(w @ bumps @ w.T, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    # torch's own bicubic is another function (a = -0.75, other edges)
    if n_out > n_in:
        theirs = torch.nn.functional.interpolate(
            torch.as_tensor(bumps)[None, None], size=(n_out, n_out),
            mode="bicubic", align_corners=False)[0, 0].numpy()
        assert np.abs(theirs - want).max() > 1e-3
