"""The fused-step kernel's launch layout (dm_control_torch/physics/fastpath.py
``launch_layout``), checked on the host: the group of lanes an environment,
the environments a block and a block's shared memory.

The kernel itself runs only on the card (tests/test_torch_cuda.py); what
the host decides, and what the kernel trusts, is checked here for the six
fast-path models and the collider model in both types, and for the largest
model ``applicable`` takes (nv 10, 160 contact rows and every joint's two
limit rows).  The card's numbers are an H100's: 132 SMs, 232,448 bytes of
shared memory a block.  Models come from the checked-in assets.
"""

import os
import types

import pytest
import torch

from _torch_helpers import ROOT
from dm_control_torch import mjcf
from dm_control_torch.physics import fastpath
from dm_control_torch.suite import base as tbase

SMS = 132
#: the six fast-path models (their assets) and the collider model
ASSETS = ("pendulum", "cartpole", "acrobot", "reacher_easy", "walker",
          "cheetah")
NARROW = ("pendulum", "cartpole", "acrobot", "reacher_easy")
DTYPES = (torch.float32, torch.float64)


def _step(name):
    if name == "colliders":
        with open(os.path.join(ROOT, "tests", "data",
                               "torch_fastpath_colliders.xml")) as f:
            m = mjcf.compile_xml_string(f.read(), device="cpu")
    else:
        m = tbase.load_model(name, "cpu", torch.float64)
    step = fastpath.build_step(m)
    assert step is not None, name
    return step


#: nv 10 (one hinge a body), the contact row cap and two limit rows a
#: joint: the most rows and dofs ``applicable`` lets through
ENVELOPE = types.SimpleNamespace(
    nbody=11, nv=10, nrows=fastpath._MAX_CONTACT_ROWS + 2 * 10,
    pairs=[{}])


def _check_layout(step, dtype):
    width, envs, nbytes = fastpath.launch_layout(step, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert width in (1, 2, 4, 8, 16, 32)
    assert width >= step.nv  # a lane a dof in the factor's substitutions
    assert 1 <= envs and width * envs <= fastpath.BLOCK_THREADS
    assert nbytes == envs * fastpath.env_bytes(step.nbody, step.nv,
                                               step.nrows, itemsize)
    assert nbytes <= fastpath.MAX_SHARED_BYTES
    assert nbytes % 16 == 0
    return width, envs, nbytes


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ASSETS + ("colliders",))
def test_layout_fits_a_block(name, dtype):
    step = _step(name)
    width, envs, _ = _check_layout(step, dtype)
    if step.pairs:  # rows across a warp
        assert width == 32 and envs == fastpath.BLOCK_THREADS // 32
    else:
        assert name in NARROW and width <= 8
        assert envs == fastpath.BLOCK_THREADS // width


@pytest.mark.parametrize("dtype", DTYPES)
def test_envelope_fits_a_block(dtype):
    width, envs, nbytes = _check_layout(ENVELOPE, dtype)
    assert width == 32 and envs >= 1
    # float64: 32,880 bytes an environment, four to a block
    if dtype == torch.float64:
        assert (envs, nbytes) == (4, 4 * 32880)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,batch", [("cartpole", 8192),
                                        ("cheetah", 4096)])
def test_grid_fills_the_card(name, batch, dtype):
    """At the timed shapes every SM gets at least 2 blocks and 8 warps."""
    blocks, warps = fastpath.launch_grid(
        fastpath.launch_layout(_step(name), dtype), batch)
    assert blocks >= 2 * SMS and warps >= 8 * SMS, (blocks, warps)


def test_env_bytes_counts_each_array():
    """cheetah (8 bodies, nv 9, 144 rows) in float32: 60 values a body, 18
    a dof, nv + 2 a row, M and 17 vectors of nv in float32; H, the factor,
    10 vectors of nv and two values a row in double; then two lists of 144
    int row indices."""
    values = 8 * 60 + 9 * 18 + 144 * 11 + 81 + 17 * 9
    solver = 2 * 81 + 10 * 9 + 2 * 144
    assert fastpath.env_bytes(8, 9, 144, 4) == 16 * -(-values * 4 // 16) \
        + 8 * solver + 1152
    assert fastpath.env_bytes(3, 2, 2, 8) == (180 + 36 + 8 + 4 + 34) * 8 \
        + (8 + 20 + 4) * 8 + 16
    # each part is padded to 16 bytes
    assert fastpath.env_bytes(2, 1, 0, 4) == 16 * ((4 * (120 + 18 + 1 + 17)
                                                    + 15) // 16) + 8 * 12


def test_layout_raises_where_an_environment_does_not_fit():
    big = types.SimpleNamespace(nbody=500, nv=10, nrows=180, pairs=[{}])
    with pytest.raises(ValueError, match="shared memory"):
        fastpath.launch_layout(big, torch.float64)


def test_applicable_refuses_a_model_past_a_block(monkeypatch):
    """The rule ``applicable`` adds to JAX's: an environment's float64
    arrays must fit a block (a model refused for it runs engine.step)."""
    m = tbase.load_model("cartpole", "cpu", torch.float64)
    assert fastpath.applicable(m)
    need = fastpath.env_bytes(m.nbody, m.nv, 2, 8)
    monkeypatch.setattr(fastpath, "MAX_SHARED_BYTES", need - 16)
    assert not fastpath.applicable(m)
