"""The port's CUDA kernel and its GPU path; these tests need a card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: a CUDA kernel has no CPU mode.  The file imports no JAX, so it
also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 2e-4 (float32) and 1e-10 (float64) between the kernel and its
plain version, as tests/test_ops_linalg.py holds the Pallas kernel; 1e-8
for a float64 control step against the JAX golden.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import PREFIXES, STATE_FIELDS, golden
from dm_control_torch import suite
from dm_control_torch.ops import linalg

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    linalg.build()
    return torch.device("cuda")


def _spd(rng, b, n, dtype, device):
    q = rng.standard_normal((b, n, n))
    a = q @ np.swapaxes(q, -1, -2) + n * np.eye(n)
    return torch.as_tensor(a, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
# n on both sides of every boundary of the launcher's rule (32 and, in
# float32, 64); 1001 fills no block of 4 warps evenly
@pytest.mark.parametrize("n,b", [(1, 5), (2, 1000), (27, 1024), (31, 1001),
                                 (32, 1001), (33, 1001), (62, 1024),
                                 (63, 1001), (64, 1001), (65, 1001),
                                 (79, 1000), (160, 3)])
def test_kernel_matches_plain_version(cuda, n, b, dtype):
    rng = np.random.default_rng(n)
    a = _spd(rng, b, n, dtype, cuda)
    rhs = torch.as_tensor(rng.standard_normal((b, n)), dtype=dtype,
                          device=cuda)
    x = linalg.chol_solve_cuda(a, rhs)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, linalg.chol_solve_reference(a, rhs),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 32, 33, 64, 65])
def test_shared_matrix_is_read_with_stride_0(cuda, n, dtype):
    """One (n, n) matrix for the batch: directly, and as an expanded view
    through the dispatcher, which hands over the one copy."""
    rng = np.random.default_rng(n)
    a = _spd(rng, 1, n, dtype, cuda)[0]
    rhs = torch.as_tensor(rng.standard_normal((1001, n)), dtype=dtype,
                          device=cuda)
    ref = linalg.chol_solve_reference(a.expand(1001, n, n), rhs)
    before = linalg.chol_solve.launches
    x = linalg.chol_solve_cuda(a, rhs)
    x_view = linalg.chol_solve(a.expand(1001, n, n), rhs)
    torch.cuda.synchronize()
    assert linalg.chol_solve.launches == before + 2
    torch.testing.assert_close(x, ref, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(x_view, x, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 32, 33, 64, 65])
def test_kernel_reads_the_lower_triangle_only(cuda, n, dtype):
    """What stands above the diagonal of a is no input, for the kernel as
    for the plain version, on both sides of the launcher's boundaries."""
    rng = np.random.default_rng(n)
    a = _spd(rng, 1001, n, dtype, cuda)
    rhs = torch.as_tensor(rng.standard_normal((1001, n)), dtype=dtype,
                          device=cuda)
    junk = a.tril() + torch.as_tensor(rng.standard_normal((1001, n, n)),
                                      dtype=dtype, device=cuda).triu(1)
    ref = linalg.chol_solve_reference(a, rhs)
    torch.testing.assert_close(linalg.chol_solve_reference(junk, rhs), ref,
                               rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(linalg.chol_solve_cuda(junk, rhs), ref,
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 62, 79])
def test_non_spd_system_gives_nan_in_its_row_only(cuda, n, dtype):
    rng = np.random.default_rng(0)
    a = _spd(rng, 64, n, dtype, cuda)
    a[5] = -a[5]
    rhs = torch.ones(64, n, dtype=dtype, device=cuda)
    x = linalg.chol_solve_cuda(a, rhs)
    ref = linalg.chol_solve_reference(a, rhs)
    assert torch.isnan(x).any(-1).nonzero().flatten().tolist() == [5]
    assert torch.isnan(x[5]).all() and torch.isnan(ref[5]).all()
    keep = torch.arange(64, device=cuda) != 5
    torch.testing.assert_close(x[keep], ref[keep], rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_dispatch_counts_launches_and_reference_switch(cuda):
    rng = np.random.default_rng(1)
    a = _spd(rng, 8, 6, torch.float32, cuda)
    rhs = torch.ones(8, 6, device=cuda)
    before = linalg.chol_solve.launches
    x = linalg.chol_solve(a, rhs)
    assert linalg.chol_solve.launches == before + 1
    with linalg.reference_solves():
        x_ref = linalg.chol_solve(a, rhs)
    assert linalg.chol_solve.launches == before + 1
    torch.testing.assert_close(x, x_ref, rtol=2e-4, atol=2e-4)
    # one matrix shared by the batch
    x_b = linalg.chol_solve(a[0], rhs)
    torch.testing.assert_close(x_b, linalg.chol_solve_reference(
        a[0].expand(8, 6, 6), rhs), rtol=2e-4, atol=2e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.eye(3, device=cuda).expand(2, 3, 3)
    rhs = torch.ones(2, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        linalg.chol_solve_cuda(a, rhs)
    with pytest.raises(TypeError):
        linalg.chol_solve_cuda(a.contiguous(), rhs.double())
    with pytest.raises(ValueError, match="n <="):
        big = torch.eye(200, device=cuda).expand(1, 200, 200).contiguous()
        linalg.chol_solve_cuda(big, torch.ones(1, 200, device=cuda))


@pytest.mark.parametrize("prefix", PREFIXES)
def test_float64_step_on_the_card_matches_the_jax_golden(cuda, prefix):
    g = golden()
    env = suite.load_batch("humanoid", "run", device=cuda,
                           dtype=torch.float64, autoreset=False)
    state = env.from_state(
        *(torch.as_tensor(g[f"{prefix}_{f}"], device=cuda)
          for f in STATE_FIELDS),
        generator=torch.Generator(device=cuda).manual_seed(0))
    before = linalg.chol_solve.launches
    state, ts = env.step(state, torch.as_tensor(g[f"{prefix}_actions"],
                                                device=cuda))
    assert linalg.chol_solve.launches - before >= 3 * env.n_sub_steps
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(state.data, f).cpu().numpy(),
                                   g[f"{prefix}_step_{f}"], rtol=0,
                                   atol=1e-8)
    for k, v in ts.observation.items():
        assert v.device.type == "cuda"
        np.testing.assert_allclose(v.cpu().numpy(), g[f"{prefix}_obs_{k}"],
                                   rtol=0, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(ts.reward.cpu().numpy(),
                               g[f"{prefix}_reward"], rtol=0, atol=1e-8)
