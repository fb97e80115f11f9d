"""Parity of the port's batched Cholesky solve with the JAX package.

``dm_control_torch.ops.linalg.chol_solve_reference`` (the plain PyTorch
version of the CUDA kernel, and what the CPU dispatcher runs) is held
against the JAX package's XLA solve, its Pallas kernel in interpret mode
(as tests/test_ops_linalg.py runs it) and a float64 numpy solve.
Tolerances are those of tests/test_ops_linalg.py: 2e-4 between float32
solvers, 2e-3 against the float64 solve, 1e-10 in float64.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
What can be tested here is its algorithm: ``_register_algorithm`` below
is a numpy transcription of the kernel's register path (square-root-free
factor with reciprocal pivots, b carried as row n of the matrix, back
substitution from the lane's own column), in the working type, and is
held to the same three references at the same tolerances.
``_block_algorithm`` is the same for the block kernel (panels of 32
columns: the diagonal block in the register scheme, the rows below it
solved against its L, the trailing update in the tiles' order, the back
substitution from U's rows), held to the plain version and the JAX
package's ``_xla_chol_solve``, which is what the JAX package runs at these
n (above its Pallas kernel's ``_MAX_N`` of 44, and below B = 256).
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


def _register_algorithm(a, rhs):
    """The register kernel of csrc/chol_solve.cu, lanes as an array axis.

    col[s, k, i] is register i of lane k of system s: entry (i, k) of the
    symmetric matrix, the whole column, loaded from the lower triangle of
    a alone (an entry above the diagonal from its mirror image).  Every
    operation stays in the type of the inputs.
    """
    batch, n = rhs.shape
    lower = np.tril(a)
    col = lower + np.swapaxes(np.tril(a, -1), 1, 2)
    z = rhs.copy()  # b as row n: one more register per lane
    rd = np.zeros_like(rhs)  # each lane's reciprocal pivot
    bad = np.zeros(batch, bool)
    one = np.ones((), a.dtype)
    with np.errstate(all="ignore"):
        for j in range(n):
            p = col[:, j, j]  # broadcast from lane j
            bad |= ~(p > 0) | ~(p - p == 0)
            rp = one / p
            rd[:, j] = rp
            f = col[:, :, j] * rp[:, None]  # each lane's own register j
            f[:, :j + 1] = 0  # lanes <= j are frozen
            v = col[:, j, j + 1:].copy()  # column j, shuffled from lane j
            col[:, :, j + 1:] -= v[:, None, :] * f[:, :, None]
            z -= z[:, j:j + 1] * f
        for j in reversed(range(n)):
            xj = z[:, j] * rd[:, j]  # broadcast from lane j
            z[:, :j] -= col[:, :j, j] * xj[:, None]  # lanes k < j
        x = z * rd
    x[bad] = np.nan
    assert x.dtype == a.dtype
    return x


def _algorithm_case(n, dtype):
    """A seeded batch with one system that is not positive definite."""
    rng = np.random.default_rng(100 + n)
    b, bad = 64, 5
    a = _spd(rng, b, n, dtype)
    a = (a + np.swapaxes(a, 1, 2)) / 2
    a[bad] = -a[bad]
    rhs = rng.standard_normal((b, n)).astype(dtype)
    x = _register_algorithm(a, rhs)
    assert np.isnan(x[bad]).all()
    good = np.arange(b) != bad
    assert np.isfinite(x[good]).all()
    return a, rhs, x, bad, good


_ALGORITHM_NS = [1, 2, 27, 32, 33, 64]
_TOL = {np.float32: 2e-4, np.float64: 1e-10}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", _ALGORITHM_NS)
def test_register_algorithm_matches_plain_version(n, dtype):
    a, rhs, x, bad, good = _algorithm_case(n, dtype)
    ref = _torch(a, rhs)
    assert np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", _ALGORITHM_NS)
def test_register_algorithm_matches_xla(n, dtype):
    a, rhs, x, bad, good = _algorithm_case(n, dtype)
    ref = np.asarray(jlinalg._xla_chol_solve(jnp.asarray(a),
                                             jnp.asarray(rhs)))
    assert ref.dtype == dtype and np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@pytest.mark.parametrize("n", [1, 2, 27])
def test_register_algorithm_matches_pallas_interpret(n):
    """The Pallas kernel is float32 only; its NaN for a pivot that is not
    > 0 stays in that system's lane.  Interpret mode unrolls n * n tiles
    and takes 9 to 21 s to trace at n = 32 to 64, so it is held at the
    sizes whose trace the cases above share."""
    a, rhs, x, bad, good = _algorithm_case(n, np.float32)
    ref = np.asarray(jlinalg.chol_solve_batched(
        jnp.asarray(a), jnp.asarray(rhs), interpret=True))
    assert np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [27, 32, 33, 64, 65])
def test_register_algorithm_reads_the_lower_triangle_only(n, dtype):
    """What stands above the diagonal of a is no input, for the kernel's
    algorithm as for the plain version."""
    rng = np.random.default_rng(200 + n)
    b = 16
    a = _spd(rng, b, n, dtype)
    rhs = rng.standard_normal((b, n)).astype(dtype)
    junk = np.tril(a) + np.triu(rng.standard_normal((b, n, n)), 1).astype(
        dtype)
    ref = _torch(a, rhs)
    np.testing.assert_allclose(_torch(junk, rhs), ref, rtol=_TOL[dtype],
                               atol=_TOL[dtype])
    np.testing.assert_allclose(_register_algorithm(junk, rhs), ref,
                               rtol=_TOL[dtype], atol=_TOL[dtype])


def test_register_algorithm_shared_matrix():
    """One matrix for the whole batch, as the kernel reads it with a batch
    stride of 0."""
    rng = np.random.default_rng(7)
    n, b = 27, 9
    a = _spd(rng, 1, n, np.float64)
    rhs = rng.standard_normal((b, n))
    x = _register_algorithm(np.broadcast_to(a, (b, n, n)), rhs)
    ref = tlinalg.chol_solve(torch.as_tensor(a[0]),
                             torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-10)


_PANEL = 32  # the block kernel's panel width: one lane a column


def _block_algorithm(a, rhs):
    """The block kernel of csrc/chol_solve.cu, systems as an array axis.

    For each panel of 32 columns: the diagonal block is factored as warp 0
    does (lane i holds row i; at step j its multiplier g_i = S[i][j] / p
    scales column j, S[k][j], out of the row), its multipliers kept as
    L11[j][i] and b's entries carried along; the rows below it solve
    U_r L11^T = S_r column by column; the trailing lower triangle and b's
    row take the rank-32 update, entry by entry in the order j of the
    panel (a tile holds its entries through the update).  Then the back
    substitution from U's rows, j descending.  Only the lower triangle of
    a is read; every operation stays in the type of the inputs.
    """
    batch, n = rhs.shape
    S = np.tril(a)  # what stands above the diagonal is never read
    z = rhs.copy()  # b as row n
    rd = np.zeros_like(rhs)
    bad = np.zeros(batch, bool)
    one = np.ones((), a.dtype)
    with np.errstate(all="ignore"):
        for c0 in range(0, n, _PANEL):
            c1 = min(c0 + _PANEL, n)
            w = c1 - c0
            block = np.tril(S[:, c0:c1, c0:c1])  # [s, i, k]: lane i's row
            L11 = np.zeros((batch, w, w), a.dtype)
            zp = z[:, c0:c1]
            for j in range(w):
                col = block[:, :, j].copy()  # the broadcast: S[k][j]
                p = col[:, j]
                bad |= ~(p > 0) | ~(p - p == 0)
                rp = one / p
                rd[:, c0 + j] = rp
                g = col * rp[:, None]  # each lane's multiplier
                g[:, :j + 1] = 0  # lanes <= j are frozen
                L11[:, j] = g
                block[:, :, j + 1:] -= g[:, :, None] * col[:, None, j + 1:]
                zp -= g * zp[:, j:j + 1]
            S[:, c0:c1, c0:c1] = np.tril(block)  # U of the diagonal block
            if c1 == n:
                break
            u = S[:, c1:, c0:c1]  # a thread a row: U_r L11^T = S_r
            for j in range(w - 1):
                u[:, :, j + 1:] -= u[:, :, j:j + 1] * L11[:, j:j + 1, j + 1:]
            lb = u * rd[:, None, c0:c1]  # L of the rows below
            for j in range(w):  # the tiles: entry by entry, j in order
                S[:, c1:, c1:] -= u[:, :, j, None] * lb[:, None, :, j]
                z[:, c1:] -= z[:, c0 + j, None] * lb[:, :, j]
        for j in reversed(range(n)):
            xj = z[:, j] * rd[:, j]  # broadcast from the lane holding j
            z[:, :j] -= S[:, j, :j] * xj[:, None]  # row j of U
        x = z * rd
    x[bad] = np.nan
    assert x.dtype == a.dtype
    return x


#: n on both sides of the branch's start (33 in float64, 65 in float32)
#: and of each panel boundary (96/97, 128), the nv of the models that take
#: it (38, 39, 62, 73, 79, 85) and the largest n
_BLOCK_NS = [33, 38, 39, 62, 65, 73, 79, 85, 96, 97, 128, 160]
_BLOCK_CASES = [(n, np.float64) for n in _BLOCK_NS] + [
    (n, np.float32) for n in _BLOCK_NS if n > 64]


def _block_case(n, dtype):
    """A seeded batch with one system that is not positive definite."""
    rng = np.random.default_rng(300 + n)
    b, bad = 16, 5
    a = _spd(rng, b, n, dtype)
    a = (a + np.swapaxes(a, 1, 2)) / 2
    a[bad] = -a[bad]
    rhs = rng.standard_normal((b, n)).astype(dtype)
    x = _block_algorithm(a, rhs)
    assert np.isnan(x[bad]).all()
    good = np.arange(b) != bad
    assert np.isfinite(x[good]).all()
    return a, rhs, x, bad, good


@pytest.mark.parametrize("n,dtype", _BLOCK_CASES)
def test_block_algorithm_matches_plain_version(n, dtype):
    a, rhs, x, bad, good = _block_case(n, dtype)
    ref = _torch(a, rhs)
    assert np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@pytest.mark.parametrize("n,dtype", _BLOCK_CASES)
def test_block_algorithm_matches_xla(n, dtype):
    a, rhs, x, bad, good = _block_case(n, dtype)
    ref = np.asarray(jlinalg._xla_chol_solve(jnp.asarray(a),
                                             jnp.asarray(rhs)))
    assert ref.dtype == dtype and np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@pytest.mark.parametrize("n,dtype", _BLOCK_CASES)
def test_block_algorithm_reads_the_lower_triangle_only(n, dtype):
    """Junk above the diagonal changes nothing, for the block kernel's
    algorithm as for the plain version."""
    rng = np.random.default_rng(400 + n)
    b = 4
    a = _spd(rng, b, n, dtype)
    rhs = rng.standard_normal((b, n)).astype(dtype)
    junk = np.tril(a) + np.triu(rng.standard_normal((b, n, n)), 1).astype(
        dtype)
    ref = _torch(a, rhs)
    np.testing.assert_allclose(_torch(junk, rhs), ref, rtol=_TOL[dtype],
                               atol=_TOL[dtype])
    np.testing.assert_allclose(_block_algorithm(junk, rhs), ref,
                               rtol=_TOL[dtype], atol=_TOL[dtype])


@pytest.mark.parametrize("n,dtype", [(38, np.float64), (73, np.float64),
                                     (73, np.float32), (85, np.float32),
                                     (160, np.float64), (160, np.float32)])
def test_block_algorithm_shared_matrix(n, dtype):
    """One matrix for the whole batch, as the kernel reads it with a batch
    stride of 0, against the dispatcher's solve of the (n, n) matrix."""
    rng = np.random.default_rng(500 + n)
    b = 6
    a = _spd(rng, 1, n, dtype)
    rhs = rng.standard_normal((b, n)).astype(dtype)
    x = _block_algorithm(np.broadcast_to(a, (b, n, n)), rhs)
    ref = tlinalg.chol_solve(torch.as_tensor(a[0]),
                             torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(x, ref, rtol=_TOL[dtype], atol=_TOL[dtype])


def test_cpu_dispatch_takes_the_reference_and_counts_no_launch():
    rng = np.random.default_rng(6)
    a = torch.as_tensor(_spd(rng, 4, 5, np.float64))
    rhs = torch.as_tensor(rng.standard_normal((4, 5)))
    before = tlinalg.chol_solve.launches
    branches = dict(tlinalg.chol_solve.branch_launches)
    x = tlinalg.chol_solve(a, rhs)
    assert tlinalg.chol_solve.launches == before
    assert tlinalg.chol_solve.branch_launches == branches
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
