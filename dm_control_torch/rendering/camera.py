"""Camera poses and the render entry points, mirroring dm_control's Camera.

Counterpart of ``dm_control_tpu/rendering/camera.py`` (reference:
dm_control/mujoco/engine.py:593-983, ``Camera`` and ``Physics.render``,
and mj_camlight's camera modes).  The scene stays on the physics' device:
the camera's pose and its rays are float64 tensor work there (the JAX
package does them in float64 numpy), environment 0's geom poses are read
where they lie, and the rays are cast in float32 (``raster.cast_rays``).
What a frame copies to the host is the returned image.  What the renderer
keeps of a model (its geoms grouped by intersector, the height fields'
boxes, the meshes' k-DOP rows, the colours) is built once per model.
"""

from __future__ import annotations

import collections
import weakref
from typing import Union

import numpy as np
import torch

from dm_control_torch.physics.model import GeomType
from dm_control_torch.rendering import raster

# mjv defaults (mjVisual.global_): the free camera's fovy, azimuth and
# elevation.
_DEFAULT_FOVY = 45.0
_DEFAULT_AZIMUTH = 90.0
_DEFAULT_ELEVATION = -45.0
_F64 = torch.float64
_F32 = torch.float32


def _forward(azimuth, elevation):
    """The unit vector a camera at (azimuth, elevation) in degrees looks
    along."""
    az, el = np.deg2rad(azimuth), np.deg2rad(elevation)
    return np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.sin(el)])


def _quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ]).reshape(3, 3)


def _lookat_frame(zaxis):
    """Camera rotation whose -z looks along -zaxis, world-up aligned."""
    z = zaxis / torch.clamp(torch.linalg.vector_norm(zaxis), min=1e-12)
    up = torch.where(z[2].abs() > 0.9999,
                     torch.tensor([0.0, 1.0, 0.0], dtype=z.dtype,
                                  device=z.device),
                     torch.tensor([0.0, 0.0, 1.0], dtype=z.dtype,
                                  device=z.device))
    x = torch.linalg.cross(up, z)
    x = x / torch.clamp(torch.linalg.vector_norm(x), min=1e-12)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=1)


def camera_pose(physics, camera_id: int):
    """(pos (3,), mat (3, 3) world <- camera, fovy in degrees ()), float64
    tensors on the physics' device, of a model camera or of the default
    free camera (``camera_id == -1``)."""
    m, d = physics.model, physics.data
    device = m.device
    if camera_id == -1:
        forward = torch.tensor(_forward(_DEFAULT_AZIMUTH, _DEFAULT_ELEVATION),
                               dtype=_F64, device=device)
        pos = m.stat.center.to(_F64) - forward * 1.5 * m.stat.extent.to(_F64)
        return (pos, _lookat_frame(-forward),
                torch.tensor(_DEFAULT_FOVY, dtype=_F64, device=device))

    if not 0 <= camera_id < m.ncam:
        raise ValueError(f"camera_id {camera_id} out of range "
                         f"(ncam={m.ncam})")
    b = m.cam_bodyid[camera_id]
    mode = m.cam_mode[camera_id]
    xpos, xmat = d.xpos[b].to(_F64), d.xmat[b].to(_F64)
    fovy = m.cam_fovy[camera_id].to(_F64)
    if mode == 1:  # track: a constant world offset, the qpos0 orientation
        return (xpos + m.cam_pos0[camera_id].to(_F64),
                m.cam_mat0[camera_id].to(_F64), fovy)
    if mode == 2:  # trackcom
        return (d.subtree_com[b].to(_F64) + m.cam_poscom0[camera_id].to(_F64),
                m.cam_mat0[camera_id].to(_F64), fovy)
    pos = xpos + xmat @ m.cam_pos[camera_id].to(_F64)
    cmat = xmat @ _quat_to_mat(m.cam_quat[camera_id].to(_F64))
    tb = m.cam_targetbodyid[camera_id]
    if mode == 0 or tb < 0:  # fixed, or a target mode without a target
        return pos, cmat, fovy
    # targetbody / targetbodycom: the position fixed, the orientation
    # following the target
    target = d.subtree_com[tb] if mode == 4 else d.xpos[tb]
    return pos, _lookat_frame(pos - target.to(_F64)), fovy


def _ray_directions(mat, fovy, height, width):
    """(H * W, 3) float64 unit world-frame rays through the pixel centres,
    row by row from the top left."""
    kw = dict(dtype=_F64, device=mat.device)
    tan_v = torch.tan(torch.deg2rad(torch.as_tensor(fovy, **kw)) * 0.5)
    tan_h = tan_v * width / height
    xs = (2.0 * (torch.arange(width, **kw) + 0.5) / width - 1.0) * tan_h
    ys = (1.0 - 2.0 * (torch.arange(height, **kw) + 0.5) / height) * tan_v
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    dirs = torch.stack([xx, yy, -torch.ones_like(xx)], dim=-1).reshape(-1, 3)
    dirs = dirs @ mat.T
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


class _Layout:
    """What the renderer keeps of a model: its geoms grouped by intersector
    (``raster.group_geoms``) with each height field's bounding box and each
    mesh's k-DOP row, the lift of each height field box's centre, and the
    colours, on the model's device."""

    def __init__(self, m):
        types = tuple(int(t) for t in m.geom_type)
        device = m.device
        size = m.geom_size.to(_F64).clone()
        hfields = [g for g, gt in enumerate(types)
                   if gt == int(GeomType.HFIELD) and m.geom_dataid[g] >= 0]
        self.hfield_ids = torch.as_tensor(hfields, dtype=torch.long,
                                          device=device)
        self.hfield_lift = None
        if hfields:
            # rx, ry, elevation, base -> a box about the field's middle
            hs = m.hfield_size.to(_F64)[[m.geom_dataid[g] for g in hfields]]
            size[self.hfield_ids] = torch.stack(
                [hs[:, 0], hs[:, 1], 0.5 * (hs[:, 2] + hs[:, 3])], dim=-1)
            self.hfield_lift = 0.5 * (hs[:, 2] - hs[:, 3])
        kdop = None
        if m.nmesh:
            meshes = [g for g, gt in enumerate(types)
                      if gt == int(GeomType.MESH) and m.geom_dataid[g] >= 0]
            sup = m.mesh_kdop.to(_F32)
            kdop = torch.zeros((len(types), sup.shape[1]), dtype=_F32,
                               device=device)
            kdop[meshes] = sup[[m.geom_dataid[g] for g in meshes]]
        self.groups = raster.group_geoms(types, size.to(_F32),
                                         m.geom_rbound.to(_F32),
                                         geom_kdop=kdop)
        self.rgba = m.geom_rgba.to(_F32)


_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _layout(m) -> _Layout:
    layout = _LAYOUTS.get(m)
    if layout is None:
        layout = _LAYOUTS[m] = _Layout(m)
    return layout


def _scene_arrays(physics, layout: _Layout):
    """Environment 0's geom positions and orientations (float64, on the
    device), each height field's box centre lifted to its middle."""
    d = physics.data
    pos = d.geom_xpos.to(_F64)
    mat = d.geom_xmat.to(_F64)
    if layout.hfield_lift is not None:
        ids = layout.hfield_ids
        pos = pos.clone()
        pos[ids] = pos[ids] + mat[ids, :, 2] * layout.hfield_lift[:, None]
    return pos, mat


class Camera:
    """Ray-cast camera over a Physics, mirroring engine.Camera."""

    def __init__(self, physics, height: int = 240, width: int = 320,
                 camera_id: Union[int, str] = -1, **_unused):
        if isinstance(camera_id, str):
            camera_id = physics.model.names.camera[camera_id]
        self._physics = physics
        self._height = height
        self._width = width
        self._camera_id = int(camera_id)

    @property
    def height(self):
        return self._height

    @property
    def width(self):
        return self._width

    @property
    def matrix(self) -> np.ndarray:
        """3x4 world -> pixel projection (engine.py:816 Camera.matrix)."""
        pos, rot, fovy = (x.cpu().numpy() for x in self._world_pose())
        # the image plane at focal length f (pixels), the principal point
        # centred
        focal = 0.5 * self._height / np.tan(np.deg2rad(fovy) * 0.5)
        image = np.array([[-focal, 0, 0.5 * (self._width - 1)],
                          [0, focal, 0.5 * (self._height - 1)],
                          [0, 0, 1.0]])
        # world -> camera: x_cam = R^T (x - pos); the camera looks along -z
        ext = np.hstack([rot.T, -(rot.T @ pos)[:, None]])
        return image @ ext

    def _world_pose(self):
        return camera_pose(self._physics, self._camera_id)

    def render(self, depth: bool = False, segmentation: bool = False,
               scene_option=None, render_flag_overrides=None):
        """uint8 (H, W, 3) RGB, float32 (H, W) plane depth in meters, or
        int32 (H, W, 2) [objid, objtype] segmentation, as numpy."""
        if depth and segmentation:
            raise ValueError("depth and segmentation are exclusive")
        layout = _layout(self._physics.model)
        pos, rot, fovy = self._world_pose()
        dirs = _ray_directions(rot, fovy, self._height, self._width)
        gpos, gmat = _scene_arrays(self._physics, layout)
        rgb, zdist, segid = raster.cast_rays(
            pos.to(_F32), dirs.to(_F32), gpos.to(_F32), gmat.to(_F32),
            layout.rgba, layout.groups)
        if segmentation:
            return raster.segmentation_image(segid, self._height,
                                             self._width)
        if depth:
            # plane depth: the distance along the camera's forward (-z) axis
            along = zdist * (dirs @ -rot[:, 2]).to(_F32)
            return along.reshape(self._height, self._width).cpu().numpy()
        return rgb.reshape(self._height, self._width, 3).cpu().numpy()


class Pose(collections.namedtuple("Pose",
                                  ("lookat", "distance", "azimuth",
                                   "elevation"))):
    """Camera pose (reference engine.py:929 Pose namedtuple)."""
    __slots__ = ()


class MovableCamera(Camera):
    """A camera with an explicit, settable free-camera pose (reference
    engine.py:939 MovableCamera).  The pose is kept on the host."""

    def __init__(self, physics, height: int = 240, width: int = 320,
                 **_unused):
        super().__init__(physics, height, width, camera_id=-1)
        stat = physics.model.stat
        self._pose = Pose(lookat=stat.center.to(_F64).cpu().numpy(),
                          distance=1.5 * float(stat.extent),
                          azimuth=_DEFAULT_AZIMUTH,
                          elevation=_DEFAULT_ELEVATION)

    def get_pose(self) -> Pose:
        return self._pose

    def set_pose(self, lookat, distance, azimuth, elevation):
        self._pose = Pose(lookat=np.asarray(lookat, np.float64),
                          distance=float(distance),
                          azimuth=float(azimuth),
                          elevation=float(elevation))

    def _world_pose(self):
        forward = _forward(self._pose.azimuth, self._pose.elevation)
        pos = np.asarray(self._pose.lookat) - forward * self._pose.distance
        device = self._physics.model.device
        return (torch.tensor(pos, dtype=_F64, device=device),
                _lookat_frame(torch.tensor(-forward, dtype=_F64,
                                           device=device)),
                torch.tensor(_DEFAULT_FOVY, dtype=_F64, device=device))


def render(physics, height: int = 240, width: int = 320,
           camera_id: Union[int, str] = -1, overlays=(), depth: bool = False,
           segmentation: bool = False, scene_option=None,
           render_flag_overrides=None, scene_callback=None):
    """Functional form of Physics.render (engine.py:168-217)."""
    cam = Camera(physics, height, width, camera_id)
    return cam.render(depth=depth, segmentation=segmentation)
