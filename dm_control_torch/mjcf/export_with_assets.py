"""Export an MJCF model (plus referenced asset payloads) to disk.

The port's copy of ``dm_control_tpu/mjcf/export_with_assets.py`` (it holds no
PyTorch: the element tree and numpy only).

Reference: dm_control/mjcf/export_with_assets.py — writes the XML and
every asset file a model references so the directory is loadable
standalone (incl. by stock MuJoCo).
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional


def _collect_asset_files(root) -> Dict[str, Optional[bytes]]:
    """File names referenced by <mesh>/<hfield>/<texture>/<skin> elements,
    mapped to payload bytes when the element carries them."""
    out: Dict[str, Optional[bytes]] = {}
    for e in root.iter():
        if e.tag in ("mesh", "hfield", "texture", "skin", "include"):
            fname = e.get("file")
            if fname:
                out[str(fname)] = getattr(e, "payload", None)
    return out


def export_with_assets(mjcf_model, out_dir: str,
                       out_file_name: Optional[str] = None,
                       assets: Optional[Dict[str, bytes]] = None) -> str:
    """Writes the model XML and its assets into ``out_dir``; returns the
    XML path.  ``assets`` supplies payload bytes for file references the
    element tree doesn't carry inline."""
    os.makedirs(out_dir, exist_ok=True)
    name = out_file_name or (str(mjcf_model.get("model", "model")) + ".xml")
    if not name.endswith(".xml"):
        raise ValueError(f"out_file_name must end with .xml: {name!r}")
    xml_path = os.path.join(out_dir, name)
    with open(xml_path, "w") as f:
        f.write(mjcf_model.to_xml_string())
    assets = dict(assets or {})
    for fname, payload in _collect_asset_files(mjcf_model).items():
        data = payload if payload is not None else assets.get(fname)
        if data is None:
            continue  # referenced but unavailable: leave the reference
        path = os.path.join(out_dir, os.path.basename(fname))
        mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
        with open(path, mode) as f:
            f.write(data)
    return xml_path


def export_with_assets_as_zip(mjcf_model, out_dir: str,
                              model_name: Optional[str] = None,
                              assets: Optional[Dict[str, bytes]] = None
                              ) -> str:
    """Like export_with_assets but packaged as ``<model_name>.zip``
    containing a ``<model_name>/`` directory (reference
    export_with_assets_as_zip)."""
    os.makedirs(out_dir, exist_ok=True)
    model_name = model_name or str(mjcf_model.get("model", "model"))
    zip_path = os.path.join(out_dir, model_name + ".zip")
    assets = dict(assets or {})
    with zipfile.ZipFile(zip_path, "w") as zf:
        zf.writestr(f"{model_name}/{model_name}.xml",
                    mjcf_model.to_xml_string())
        for fname, payload in _collect_asset_files(mjcf_model).items():
            data = payload if payload is not None else assets.get(fname)
            if data is None:
                continue
            zf.writestr(f"{model_name}/{os.path.basename(fname)}", data)
    return zip_path
