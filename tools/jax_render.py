"""Renders scenes of the PyTorch port through the JAX package's renderer.

The JAX package's ``rendering`` reads a physics' ``model`` and ``data``
as arrays; ``scene_job`` takes them from the port's ``Physics`` (its
model fields and environment 0's state, as numpy), ``rays_job`` takes
``raster.render_rays``'s arguments.  ``render`` runs the jobs in a fresh
process:

    python tools/jax_render.py JOBS.npz OUT.npz

whose XLA CPU backend is held to the AVX instruction set
(``--xla_cpu_max_isa=AVX``), which has no fused multiply-add.  XLA
otherwise contracts a float32 multiply and add into one FMA wherever the
CPU has one, and a ray cast amplifies that rounding near a silhouette (a
grazing ray's quadratic has a discriminant near 0: a capsule cap 3.6 m
away came out 6.7e-4 m apart with and without it).  Without FMA the JAX
program's float32 operations are rounded one by one, as PyTorch's are.
Used by the port's render tests and ``export_torch_assets.py
render_goldens``; imports JAX only in the process it starts.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA_NO_FMA = "--xla_cpu_max_isa=AVX"
#: the model fields the JAX camera reads, besides the static ones below
_MODEL_ARRAYS = ("geom_size", "geom_rbound", "geom_rgba", "hfield_size",
                 "mesh_kdop", "cam_pos", "cam_quat", "cam_fovy",
                 "cam_pos0", "cam_poscom0", "cam_mat0")
_MODEL_INTS = ("geom_type", "geom_dataid", "cam_bodyid", "cam_mode",
               "cam_targetbodyid")
_DATA_ARRAYS = ("xpos", "xmat", "subtree_com", "geom_xpos", "geom_xmat")


def scene_job(physics, height, width, camera_id=-1, pose=None,
              kinds=("rgb", "depth", "seg"), state=None):
    """A job rendering the port's ``physics`` (environment 0) from model
    camera ``camera_id`` (an id; -1 the default free camera) or, with
    ``pose`` (lookat x, y, z, distance, azimuth, elevation), from a
    ``MovableCamera`` there.  ``state`` overrides ``physics.data``'s
    fields (a recording's ``STATE_FIELDS``)."""
    m = physics.model
    job = {"kind": "scene", "height": height, "width": width,
           "camera": camera_id, "kinds": list(kinds),
           "ncam": m.ncam, "nmesh": m.nmesh, "nhfield": m.nhfield,
           "stat_center": m.stat.center.double().cpu().numpy(),
           "stat_extent": float(m.stat.extent)}
    for f in _MODEL_ARRAYS:
        v = getattr(m, f)
        if v is not None:
            job[f] = v.cpu().numpy()
    for f in _MODEL_INTS:
        job[f] = np.asarray(getattr(m, f), np.int64)
    for f in _DATA_ARRAYS:
        job[f"d_{f}"] = (state[f] if state is not None
                         else getattr(physics.data, f).cpu().numpy())
    if pose is not None:
        job["pose"] = np.asarray(pose, np.float64)
    return job


def rays_job(origin, dirs, geom_pos, geom_mat, geom_size, geom_rbound,
             geom_rgba, geom_types, mesh_as_sphere=True, geom_kdop=None):
    """A job calling the JAX ``raster.render_rays`` on these float32
    arrays."""
    job = {"kind": "rays", "origin": origin, "dirs": dirs,
           "geom_pos": geom_pos, "geom_mat": geom_mat,
           "geom_size": geom_size, "geom_rbound": geom_rbound,
           "geom_rgba": geom_rgba,
           "geom_types": np.asarray(geom_types, np.int64),
           "mesh_as_sphere": mesh_as_sphere}
    if geom_kdop is not None:
        job["geom_kdop"] = geom_kdop
    return job


def render(jobs, timeout=600):
    """Runs ``jobs`` (a list) in a fresh process without FMA; returns one
    dict a job: ``rgb``, ``depth``, ``seg`` (a scene job's frames, seg
    its geom ids) or ``rgb``, ``zdist``, ``segid`` (a rays job's)."""
    flat = {}
    for i, job in enumerate(jobs):
        for k, v in job.items():
            flat[f"{i}/{k}"] = np.asarray(v)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} {XLA_NO_FMA}".strip()
    env["JAX_PLATFORMS"] = "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "jobs.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, **flat)
        subprocess.run([sys.executable, os.path.abspath(__file__), src, dst],
                       check=True, env=env, timeout=timeout)
        with np.load(dst) as z:
            out = [{} for _ in jobs]
            for key in z.files:
                i, k = key.split("/")
                out[int(i)][k] = z[key]
    return out


def _shim(job):
    """A physics-like object of a scene job for the JAX camera."""
    model = types.SimpleNamespace(
        ncam=int(job["ncam"]), nmesh=int(job["nmesh"]),
        nhfield=int(job["nhfield"]),
        stat=types.SimpleNamespace(center=job["stat_center"],
                                   extent=float(job["stat_extent"])),
        names=types.SimpleNamespace(camera={}),
        **{f: job.get(f) for f in _MODEL_ARRAYS},
        **{f: tuple(int(x) for x in job[f]) for f in _MODEL_INTS})
    data = types.SimpleNamespace(**{f: job[f"d_{f}"] for f in _DATA_ARRAYS})
    return types.SimpleNamespace(model=model, data=data)


def _run(job):
    import jax.numpy as jnp

    from dm_control_tpu.rendering import camera, raster

    if job["kind"] == "rays":
        f32 = jnp.float32
        kdop = job.get("geom_kdop")
        rgb, zdist, segid = raster.render_rays(
            *(jnp.asarray(job[k], f32) for k in (
                "origin", "dirs", "geom_pos", "geom_mat", "geom_size",
                "geom_rbound", "geom_rgba")),
            tuple(int(t) for t in job["geom_types"]),
            mesh_as_sphere=bool(job["mesh_as_sphere"]),
            geom_kdop=None if kdop is None else jnp.asarray(kdop, f32))
        return {"rgb": rgb, "zdist": zdist, "segid": segid}
    physics = _shim(job)
    h, w = int(job["height"]), int(job["width"])
    if "pose" in job:
        cam = camera.MovableCamera(physics, h, w)
        pose = job["pose"]
        cam.set_pose(pose[:3], *pose[3:])
    else:
        cam = camera.Camera(physics, h, w, int(job["camera"]))
    out = {}
    for kind in job["kinds"]:
        frame = np.asarray(cam.render(depth=kind == "depth",
                                      segmentation=kind == "seg"))
        out[kind] = frame[..., 0] if kind == "seg" else frame
    return out


def main(argv=None):
    src, dst = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, ROOT)
    jobs = {}
    with np.load(src) as z:
        for key in z.files:
            i, k = key.split("/")
            v = z[key]
            jobs.setdefault(int(i), {})[k] = v.item() if v.ndim == 0 \
                else (list(v) if k == "kinds" else v)
    out = {}
    for i in sorted(jobs):
        for k, v in _run(jobs[i]).items():
            out[f"{i}/{k}"] = np.asarray(v)
    np.savez(dst, **out)


if __name__ == "__main__":
    main()
