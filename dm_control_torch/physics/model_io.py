"""Saving and loading a ``Model`` as one ``.npz`` file.

The port compiles the suite's models itself (``mjcf.compile_model``); a
file holds the JAX compiler's output for a model, as the reference the
port's compiler is tested against and as the model of a composer task
that the port does not build yet: every numeric leaf as an array, and
every static field (ints, nested tuples, the name maps) in one JSON
string under the key ``__static__``.  No pickle is involved; ``load``
reads with ``allow_pickle=False``.

``from_jax_model`` converts a compiled ``dm_control_tpu`` model by walking
its dataclass fields; it needs only numpy (``np.asarray`` of each leaf),
so this module never imports jax.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np
import torch

from dm_control_torch.physics.model import Model, NameMap, Option, Statistic

_NESTED = {"opt": Option, "stat": Statistic}
_STATIC_KEY = "__static__"


def _is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static", False))


def _to_json(value):
    if isinstance(value, (tuple, list)):
        return [_to_json(v) for v in value]
    if isinstance(value, np.generic):
        return value.item()
    return value


def _from_json(value):
    if isinstance(value, list):
        return tuple(_from_json(v) for v in value)
    return value


def _names_to_dict(names) -> Dict[str, Dict[str, int]]:
    return {slot: {str(k): int(v) for k, v in getattr(names, slot).items()}
            for slot in NameMap.SLOTS}


def _flatten(src, fields, prefix, arrays, static, leaf):
    for f in fields:
        value = getattr(src, f.name)
        key = prefix + f.name
        if f.name == "names":
            static[key] = None if value is None else _names_to_dict(value)
        elif _is_static(f):
            static[key] = _to_json(value)
        elif f.name in _NESTED and not prefix:
            _flatten(value, dataclasses.fields(_NESTED[f.name]), key + ".",
                     arrays, static, leaf)
        elif value is None:
            static[key] = None
        else:
            arrays[key] = leaf(value)


def _model_fields():
    return [f for f in dataclasses.fields(Model) if f.init]


def from_jax_model(jm) -> Model:
    """A CPU ``Model`` (tensors in the leaves' own dtype) from a compiled
    ``dm_control_tpu`` model.  Fails if the two packages' fields differ."""
    port = {f.name for f in _model_fields()}
    theirs = {f.name for f in dataclasses.fields(jm)}
    if port != theirs:
        raise ValueError(f"Model fields differ from the JAX package: "
                         f"missing {sorted(theirs - port)}, "
                         f"extra {sorted(port - theirs)}")
    arrays: Dict[str, np.ndarray] = {}
    static: Dict[str, Any] = {}
    _flatten(jm, _model_fields(), "", arrays, static,
             lambda v: np.array(np.asarray(v)))
    return _build(arrays, static, torch.device("cpu"), None)


def _build(arrays, static, device, dtype) -> Model:
    def tensor(a):
        t = torch.as_tensor(np.asarray(a), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    def value(key):
        if key in arrays:
            return tensor(arrays[key])
        return _from_json(static[key])

    kwargs = {}
    for f in _model_fields():
        if f.name in _NESTED:
            cls = _NESTED[f.name]
            kwargs[f.name] = cls(**{g.name: value(f"{f.name}.{g.name}")
                                    for g in dataclasses.fields(cls)})
        elif f.name == "names":
            names = static.get("names")
            kwargs["names"] = None if names is None else NameMap(**names)
        else:
            kwargs[f.name] = value(f.name)
    return Model(**kwargs)


#: the fields ``engine.set_const`` writes; the compiler writes the rest
SET_CONST_FIELDS = ("dof_invweight0", "body_invweight0", "stat.meaninertia",
                    "jnt_stiffness", "dof_damping", "tendon_length0",
                    "tendon_invweight0", "tendon_lengthspring", "cam_pos0",
                    "cam_poscom0", "cam_mat0")


def deviations(model: Model, reference: Model) -> Dict[str, float]:
    """Field name (``opt.`` and ``stat.`` for the nested ones) -> the
    largest |model - reference| over the field's largest |entry| (0 where
    both are all zeros), for every numeric field.  Raises ``ValueError``
    where a static field, a shape or a dtype differs."""
    arrays, static = {}, {}
    ref_arrays, ref_static = {}, {}
    _flatten(model, _model_fields(), "", arrays, static, lambda v: v)
    _flatten(reference, _model_fields(), "", ref_arrays, ref_static,
             lambda v: v)
    if static != ref_static or arrays.keys() != ref_arrays.keys():
        bad = sorted(k for k in set(static) | set(ref_static)
                     if static.get(k) != ref_static.get(k))
        raise ValueError(f"static fields differ: {bad}")
    out = {}
    for k, ref in ref_arrays.items():
        v = arrays[k]
        if v.shape != ref.shape or v.dtype != ref.dtype:
            raise ValueError(f"{k}: {tuple(v.shape)} {v.dtype}, reference "
                             f"{tuple(ref.shape)} {ref.dtype}")
        if ref.numel() == 0 or torch.equal(v, ref):
            out[k] = 0.0
            continue
        dev = float((v - ref).abs().max())
        out[k] = dev / max(float(ref.abs().max()),
                           float(np.finfo(np.float64).tiny))
    return out


def to(model: Model, device, dtype: torch.dtype) -> Model:
    """A copy of ``model`` on ``device`` with every floating leaf in
    ``dtype`` (as ``load`` casts the float64 leaves of a file); no tensor
    is shared with ``model``."""
    device = torch.device(device)

    def leaf(v):
        if not isinstance(v, torch.Tensor):
            return v
        return v.to(device=device, copy=True,
                    dtype=dtype if v.is_floating_point() else v.dtype)

    kwargs = {}
    for f in _model_fields():
        v = getattr(model, f.name)
        if f.name in _NESTED:
            v = v.replace(**{g.name: leaf(getattr(v, g.name))
                             for g in dataclasses.fields(_NESTED[f.name])})
        kwargs[f.name] = leaf(v)
    return Model(**kwargs)


def save(path, model: Model) -> None:
    """Writes ``model`` to ``path`` (an ``.npz``)."""
    arrays: Dict[str, np.ndarray] = {}
    static: Dict[str, Any] = {}
    _flatten(model, _model_fields(), "", arrays, static,
             lambda v: v.detach().cpu().numpy())
    np.savez(path, **arrays, **{_STATIC_KEY: np.array(json.dumps(
        static, sort_keys=True))})


def load(path, device, dtype: torch.dtype) -> Model:
    """Reads a model saved by ``save`` onto ``device``, with every floating
    leaf in ``dtype``."""
    if device is None:
        raise ValueError("model_io.load needs an explicit device")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != _STATIC_KEY}
        static = json.loads(str(z[_STATIC_KEY]))
    return _build(arrays, static, torch.device(device), dtype)
