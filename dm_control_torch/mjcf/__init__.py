"""MJCF object model and ahead-of-time model compiler, on PyTorch.

The port's copy of ``dm_control_tpu/mjcf/``:

- ``element``: a typed MJCF element tree (DOM) that can be parsed from XML
  or built programmatically (models-as-code);
- ``parser``: XML string/file → element tree, with <include> resolution
  (the standard library's ElementTree);
- ``compiler``: element tree → ``physics.Model`` on a device, the analogue
  of mj_loadXML + mj_compile, with ``engine.set_const`` for the constants
  that need the physics;
- ``physics``: ``bind`` attribute views on a ``Physics``;
- ``debugging``: creation and attribute-write stacks of the elements, and
  annotated dumps (debug mode);
- ``export_with_assets``: the XML and its asset files to a directory or a
  zip file;
- ``skin``: ``.skn`` skin files, parsed and serialized.
"""

import torch

from dm_control_torch.mjcf.element import Element  # noqa: F401
from dm_control_torch.mjcf.parser import (  # noqa: F401
    from_path, from_xml_string,
)
from dm_control_torch.mjcf.compiler import compile_model  # noqa: F401
from dm_control_torch.mjcf.copier import copy_element  # noqa: F401
from dm_control_torch.mjcf.export_with_assets import (  # noqa: F401
    export_with_assets, export_with_assets_as_zip,
)
from dm_control_torch.mjcf.physics import Binding, bind  # noqa: F401
from dm_control_torch.mjcf.schema import (  # noqa: F401
    MJCFSchemaError, validate,
)
from dm_control_torch.mjcf.traversal_utils import commit_defaults  # noqa: F401


def compile_xml_string(xml: str, assets=None, device=None,
                       dtype: torch.dtype = torch.float64):
    """XML string → compiled Model on ``device`` (the card by default)."""
    root = from_xml_string(xml, assets=assets)
    return compile_model(root, device=device, dtype=dtype)
