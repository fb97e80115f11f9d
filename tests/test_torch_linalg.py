"""Parity of the port's batched Cholesky solve with the JAX package.

``dm_control_torch.ops.linalg.chol_solve_reference`` (the plain PyTorch
version of the CUDA kernel, and what the CPU dispatcher runs) is held
against the JAX package's XLA solve, its Pallas kernel in interpret mode
(as tests/test_ops_linalg.py runs it) and a float64 numpy solve.
Tolerances are those of tests/test_ops_linalg.py: 2e-4 between float32
solvers, 2e-3 against the float64 solve, 1e-10 in float64.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (one torch thread per worker)
from dm_control_torch.ops import linalg as tlinalg
from dm_control_tpu.ops import linalg as jlinalg


def _spd(rng, b, n, dtype=np.float32):
    q = rng.standard_normal((b, n, n)).astype(dtype)
    return q @ np.swapaxes(q, -1, -2) + n * np.eye(n, dtype=dtype)


def _np_solve(a, rhs):
    a64 = np.broadcast_to(a.astype(np.float64), rhs.shape + rhs.shape[-1:])
    return np.linalg.solve(a64, rhs.astype(np.float64)[..., None])[..., 0]


def _torch(a, rhs):
    return tlinalg.chol_solve_reference(torch.as_tensor(a),
                                        torch.as_tensor(rhs)).numpy()


@pytest.mark.parametrize("n", [2, 7, 27, 40])
def test_reference_matches_pallas_xla_and_numpy(n):
    rng = np.random.default_rng(n)
    a = _spd(rng, 64, n)
    rhs = rng.standard_normal((64, n)).astype(np.float32)
    x = _torch(a, rhs)
    x_xla = np.asarray(jlinalg._xla_chol_solve(jnp.asarray(a),
                                               jnp.asarray(rhs)))
    x_pal = np.asarray(jlinalg.chol_solve_batched(
        jnp.asarray(a), jnp.asarray(rhs), interpret=True))
    np.testing.assert_allclose(x, x_xla, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(x, x_pal, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(x, _np_solve(a, rhs), rtol=2e-3, atol=2e-3)


def test_ragged_batch():
    """A batch that is not a multiple of the Pallas kernel's 1024 block."""
    rng = np.random.default_rng(1)
    b, n = 1536, 11
    a = _spd(rng, b, n)
    rhs = rng.standard_normal((b, n)).astype(np.float32)
    x = _torch(a, rhs)
    x_pal = np.asarray(jlinalg.chol_solve_batched(
        jnp.asarray(a), jnp.asarray(rhs), interpret=True))
    np.testing.assert_allclose(x, x_pal, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(x, _np_solve(a, rhs), rtol=2e-3, atol=2e-3)


def test_broadcast_matrix():
    """One matrix shared by the batch, through the dispatcher."""
    import jax

    rng = np.random.default_rng(3)
    n, b = 6, 5
    a = _spd(rng, 1, n)[0]
    rhs = rng.standard_normal((b, n)).astype(np.float32)
    x = tlinalg.chol_solve(torch.as_tensor(a), torch.as_tensor(rhs)).numpy()
    x_jax = jax.vmap(jlinalg.chol_solve, in_axes=(None, 0))(
        jnp.asarray(a), jnp.asarray(rhs))
    np.testing.assert_allclose(x, np.asarray(x_jax), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(x, _np_solve(a, rhs), rtol=2e-3, atol=2e-3)


def test_float64():
    rng = np.random.default_rng(4)
    n = 27
    a = _spd(rng, 8, n, np.float64)
    rhs = rng.standard_normal((8, n))
    x = _torch(a, rhs)
    x_xla = np.asarray(jlinalg._xla_chol_solve(jnp.asarray(a),
                                               jnp.asarray(rhs)))
    np.testing.assert_allclose(x, x_xla, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(x, _np_solve(a, rhs), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_non_spd_env_is_nan_in_its_own_row(dtype):
    """A system that is not positive definite gives NaN in its own row of
    x, as jnp.linalg.cholesky does, and leaves the others untouched."""
    rng = np.random.default_rng(5)
    n, b, bad = 7, 6, 2
    a = _spd(rng, b, n, dtype)
    a[bad] = -a[bad]
    rhs = rng.standard_normal((b, n)).astype(dtype)
    x = _torch(a, rhs)
    x_xla = np.asarray(jlinalg._xla_chol_solve(jnp.asarray(a),
                                               jnp.asarray(rhs)))
    assert np.isnan(x[bad]).all() and np.isnan(x_xla[bad]).all()
    good = np.arange(b) != bad
    assert np.isfinite(x[good]).all()
    tol = 2e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(x[good], x_xla[good], rtol=tol, atol=tol)


def test_cpu_dispatch_takes_the_reference_and_counts_no_launch():
    rng = np.random.default_rng(6)
    a = torch.as_tensor(_spd(rng, 4, 5, np.float64))
    rhs = torch.as_tensor(rng.standard_normal((4, 5)))
    before = tlinalg.chol_solve.launches
    x = tlinalg.chol_solve(a, rhs)
    assert tlinalg.chol_solve.launches == before
    torch.testing.assert_close(x, tlinalg.chol_solve_reference(a, rhs),
                               rtol=0, atol=0)


def test_cuda_kernel_rejects_cpu_tensors():
    a = torch.eye(3, dtype=torch.float64).expand(2, 3, 3).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tlinalg.chol_solve_cuda(a, torch.ones(2, 3, dtype=torch.float64))


def test_build_without_nvcc_says_what_is_missing(monkeypatch):
    from dm_control_torch.ops import _cuda_build

    monkeypatch.setattr(_cuda_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.nvcc_path()
