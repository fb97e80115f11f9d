"""Shared helpers for suite domain modules: compiling a domain's model.

Counterpart of ``dm_control_tpu/suite/_domain.py``.  A compiled model is
kept per (literal, variant) in float64 on the host; each caller gets its
own copy on its device, cast to the dtype it asks for, so no caller can
write into another's model.
"""

from __future__ import annotations

import torch

from dm_control_torch.mjcf import compiler, schema
from dm_control_torch.physics import model_io
from dm_control_torch.suite._modelgen import to_element

_MODEL_CACHE = {}


def compile_domain_model(model_literal, mutate=None, cache_key=None, *,
                         device=None, dtype: torch.dtype = torch.float64):
    """Compiles a model literal tree (optionally mutated) into a Model on
    ``device`` (the card by default) in ``dtype``.

    ``mutate``: optional fn(Element) applied before compilation (procedural
    domains).  The host compile is cached per (literal identity,
    ``cache_key``).
    """
    device = compiler.target_device(device)
    key = (id(model_literal), cache_key)
    if key not in _MODEL_CACHE:
        root = to_element(model_literal)
        if mutate is not None:
            mutate(root)
        schema.validate_or_raise(root)
        _MODEL_CACHE[key] = compiler.compile_host(root)
    return model_io.to(_MODEL_CACHE[key], device, dtype)
