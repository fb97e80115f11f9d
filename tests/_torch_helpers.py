"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*).

The compiled JAX humanoid model takes many seconds to build, so it is
built once per test process and shared by every file that needs it.
"""

import functools
import importlib.util
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_humanoid_golden_f64.npz")
STATE_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time")
#: the golden's start states: after a reset, and on the floor
PREFIXES = ("reset", "contact")

# one thread per test process: the suite runs under several xdist workers
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_humanoid_model():
    from dm_control_tpu.suite import humanoid

    return humanoid.get_model()


@functools.lru_cache(maxsize=None)
def export_tool():
    """The asset tool (tools/export_torch_assets.py) as a module."""
    path = os.path.join(ROOT, "tools", "export_torch_assets.py")
    spec = importlib.util.spec_from_file_location("export_torch_assets",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def golden():
    with np.load(GOLDEN, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
