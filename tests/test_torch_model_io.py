"""The port's model files: exact round trip, every checked-in asset equal
to a fresh export, and no JAX anywhere in the port."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_helpers import ROOT, export_tool, jax_model
from dm_control_torch.physics import model_io
from dm_control_torch.physics.model import Model
from dm_control_torch.suite import base as tbase

ASSETS = tuple(a for assets in export_tool().ASSETS.values() for a in assets)
#: domains whose assets tests/test_torch_finger.py,
#: tests/test_torch_manipulator.py, tests/test_torch_humanoid_cmu.py,
#: tests/test_torch_lqr.py and tests/test_torch_dog.py check against a
#: fresh export through this file's function: those files compile the JAX
#: models anyway
ELSEWHERE = ("finger", "manipulator", "stacker", "humanoid_CMU", "lqr",
             "dog")


def _fields(model):
    """{name: value} over every saved field, nested options flattened."""
    out = {}
    for f in dataclasses.fields(Model):
        if not f.init:
            continue
        v = getattr(model, f.name)
        if f.name in ("opt", "stat"):
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = getattr(v, g.name)
        else:
            out[f.name] = v
    return out


def _assert_same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if isinstance(va, torch.Tensor):
            assert isinstance(vb, torch.Tensor), k
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert torch.equal(va, vb), k
        else:
            assert va == vb, k


@pytest.fixture(scope="module")
def exported():
    return model_io.from_jax_model(jax_model("humanoid"))


def test_from_jax_model_matches_the_jax_leaves(exported):
    jm = jax_model("humanoid")
    np.testing.assert_array_equal(exported.qpos0.numpy(),
                                  np.asarray(jm.qpos0))
    np.testing.assert_array_equal(exported.opt.gravity.numpy(),
                                  np.asarray(jm.opt.gravity))
    assert exported.body_tree_levels == jm.body_tree_levels
    assert exported.collision_pairs == jm.collision_pairs
    assert exported.names.body == jm.names.body
    assert exported.dtype == torch.float64


def test_save_load_round_trip_is_exact(exported, tmp_path):
    path = os.path.join(tmp_path, "model.npz")
    model_io.save(path, exported)
    _assert_same(model_io.load(path, "cpu", torch.float64), exported)


@pytest.mark.parametrize("asset", [
    a for d, assets in export_tool().ASSETS.items() if d not in ELSEWHERE
    for a in assets])
def test_checked_in_asset_equals_a_fresh_export(asset):
    _assert_same(tbase.load_model(asset, "cpu", torch.float64),
                 model_io.from_jax_model(jax_model(asset)))


def test_every_asset_file_belongs_to_a_task():
    """Every reference file is the model of a task (a task's ``Variant``
    names it); dog's trot and run compile floors no file holds."""
    import dm_control_torch.suite as tsuite

    used = {domain.TASKS[t]()[0].name for domain in tsuite.DOMAINS.values()
            for t in domain.TASKS}
    on_disk = {f[:-len(".npz")] for f in os.listdir(os.path.dirname(
        tbase.asset_path("humanoid")))}
    assert on_disk == set(ASSETS)
    assert used - on_disk == {"dog_trot", "dog_run"}


def test_load_casts_floating_leaves_and_keeps_static_fields():
    m = tbase.load_model("humanoid", "cpu", torch.float32)
    assert m.dtype == torch.float32 and m.device.type == "cpu"
    assert m.opt.timestep.dtype == torch.float32
    assert m.body_mass.dtype == torch.float32
    assert (m.nq, m.nv, m.nu, m.nbody) == (28, 27, 21, 17)
    with pytest.raises(ValueError, match="device"):
        model_io.load(tbase.asset_path("humanoid"), None, torch.float32)


_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"dm_control_tpu|lxml)\b", re.MULTILINE)


def test_port_sources_import_no_jax():
    """No module of the port imports JAX, the JAX package or ``lxml`` (the
    JAX package's XML parser; the machine with the card has none)."""
    offenders = []
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dm_control_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            if _JAX_IMPORT.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_port_runs_without_jax_loaded():
    code = (
        "import sys, torch\n"
        "from dm_control_torch import suite\n"
        "env = suite.load_batch('humanoid', 'run', device='cpu',"
        " dtype=torch.float64)\n"
        "env.reset(2, torch.Generator().manual_seed(0))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'dm_control_tpu', 'lxml')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
