"""Rescaling a walker's tree (counterpart of
``dm_control_tpu/locomotion/walkers/rescale.py``; reference:
dm_control/locomotion/walkers/rescale.py).

Works on the element tree (string attributes) before compiling:
positions scale by ``position_factor``, geom sizes by ``size_factor``;
a ``fromto`` segment scales its midpoint and its half-extent separately.
"""

from __future__ import annotations

import numpy as np


def _get_vec(elem, key):
    v = elem.get(key)
    if v is None:
        return None
    return np.fromstring(str(v), sep=" ") if isinstance(v, str) \
        else np.asarray(v, float)


def _set_vec(elem, key, value):
    elem.attrib[key] = " ".join(f"{x:g}" for x in np.asarray(value).ravel())


def rescale_subtree(body, position_factor, size_factor):
    """Recursively rescales a subtree of the element tree."""
    for child in body.children:
        fromto = _get_vec(child, "fromto")
        if fromto is not None:
            mid = position_factor * 0.5 * (fromto[3:] + fromto[:3])
            half = size_factor * 0.5 * (fromto[3:] - fromto[:3])
            _set_vec(child, "fromto",
                     np.concatenate([mid - half, mid + half]))
        pos = _get_vec(child, "pos")
        if pos is not None:
            _set_vec(child, "pos", pos * position_factor)
        size = _get_vec(child, "size")
        if size is not None and child.tag == "geom":
            _set_vec(child, "size", size * size_factor)
        if child.tag in ("body", "worldbody"):
            rescale_subtree(child, position_factor, size_factor)


def rescale_humanoid(walker, position_factor, size_factor=None, mass=None):
    """Rescales a walker's lengths/sizes (and optionally total mass, by
    scaling geom masses/densities uniformly)."""
    if size_factor is None:
        size_factor = position_factor
    root = walker.mjcf_model.first("worldbody") or walker.mjcf_model
    rescale_subtree(root, position_factor, size_factor)
    if mass is not None:
        geoms = [g for g in walker.mjcf_model.iter() if g.tag == "geom"]
        current = 0.0
        for g in geoms:
            gm = g.get("mass")
            current += float(gm) if gm is not None else 0.0
        if current > 0:
            factor = mass / current
            for g in geoms:
                gm = g.get("mass")
                if gm is not None:
                    g.attrib["mass"] = f"{float(gm) * factor:g}"
                else:
                    dens = float(g.get("density", 1000))
                    g.attrib["density"] = f"{dens * factor:g}"
