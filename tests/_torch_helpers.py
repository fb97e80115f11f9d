"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*).

A compiled JAX model takes many seconds to build, so each is built once
per test process and shared by every file that needs it.
"""

import functools
import importlib.util
import os

import numpy as np
import torch

from dm_control_torch.rl.golden import PREFIXES, STATE_FIELDS  # noqa: F401
from dm_control_torch.rl.golden import start_state as golden_state  # noqa: F401
from dm_control_torch.rl.golden import step_errors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one thread per test process: the suite runs under several xdist workers
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def export_tool():
    """The asset tool (tools/export_torch_assets.py) as a module."""
    path = os.path.join(ROOT, "tools", "export_torch_assets.py")
    spec = importlib.util.spec_from_file_location("export_torch_assets",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def jax_model(asset):
    """The JAX package's compiled model behind one of the port's asset
    names (``export_tool().ASSETS``)."""
    return export_tool().jax_model(asset)


def golden(domain="humanoid"):
    """The domain's golden file (tools/export_torch_assets.py) as a dict."""
    with np.load(export_tool().golden_path(domain), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def assert_step_matches_golden(env, gold, prefix, atol=1e-8):
    """One ``env.step`` from the golden's ``prefix`` start states equals the
    JAX result within ``atol`` in state, every observation and reward, and
    exactly in discount and step type.  Prints the largest deviation (shown
    with ``pytest -s``)."""
    errs = step_errors(env, gold, prefix)
    worst = max(errs, key=errs.get)
    print(f"\n{prefix}: max |port - JAX| {errs[worst]:.3e} ({worst})")
    assert errs[worst] <= atol, (worst, errs[worst])
    assert errs["discount"] == 0 and errs["step_type"] == 0, errs
