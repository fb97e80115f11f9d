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
``_global_algorithm`` is the global kernel's (the same factor, the back
substitution by panels), held to both at n past the block kernel's
largest, and to the Pallas kernel in interpret mode with narrow panels.
"""

import functools

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


def _factor_panels(a, rhs, panel):
    """The factor of the block and global kernels of csrc/chol_solve.cu,
    systems as an array axis, panels of ``panel`` columns (32 in the
    kernels).

    For each panel: the diagonal block is factored as warp 0 does (lane i
    holds row i; at step j its multiplier g_i = S[i][j] / p scales column
    j, S[k][j], out of the row), its multipliers kept as L11[j][i] and b's
    entries carried along; the rows below it solve U_r L11^T = S_r column
    by column; the trailing lower triangle and b's row take the rank-32
    update, entry by entry in the order j of the panel (a tile holds its
    entries through the update).  Only the lower triangle of a is read;
    every operation stays in the type of the inputs.  Returns U (the
    factor's rows, lower triangle), z = L^-1 b, the reciprocal pivots and
    which systems are not positive definite.
    """
    batch, n = rhs.shape
    S = np.tril(a)  # what stands above the diagonal is never read
    z = rhs.copy()  # b as row n
    rd = np.zeros_like(rhs)
    bad = np.zeros(batch, bool)
    one = np.ones((), a.dtype)
    with np.errstate(all="ignore"):
        for c0 in range(0, n, panel):
            c1 = min(c0 + panel, n)
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
    return S, z, rd, bad


def _block_algorithm(a, rhs):
    """The block kernel: ``_factor_panels`` with panels of 32 columns, then
    the back substitution from U's rows, j descending."""
    S, z, rd, bad = _factor_panels(a, rhs, _PANEL)
    with np.errstate(all="ignore"):
        for j in reversed(range(rhs.shape[1])):
            xj = z[:, j] * rd[:, j]  # broadcast from the lane holding j
            z[:, :j] -= S[:, j, :j] * xj[:, None]  # row j of U
        x = z * rd
    x[bad] = np.nan
    assert x.dtype == a.dtype
    return x


def _global_algorithm(a, rhs, panel=_PANEL):
    """The global kernel: ``_factor_panels`` (the triangle in device memory,
    the same operations in the same order), then the back substitution by
    panels, the last first: rank 0's warp 0 solves the panel's triangle
    from its lanes' z, then every z entry of the panels before it gives up
    the panel's x, j descending.  Each z entry takes its terms in the order
    the block kernel's lane takes them in.

    What of the kernel's order the model keeps: every entry of the trailing
    update takes its 32 updates in the order j, as the kernel's float32
    tiles do one FMA at a time and as its float64 DMMA does in 8 k-groups
    of 4 (an H100 rounds each product of a k-group in turn: m16n8k4 gave
    the same bits as FMAs one after the other).  How the kernel deals the
    rows below, the update's blocks and the z entries out over a cluster's
    CTAs, and the lookahead that factors the next panel during the update,
    change no entry's order.  The model rounds each product before it
    subtracts it, where the kernel fuses the two: it keeps the kernel's
    order, not its last bits."""
    S, z, rd, bad = _factor_panels(a, rhs, panel)
    n = rhs.shape[1]
    with np.errstate(all="ignore"):
        for c0 in reversed(range(0, n, panel)):
            c1 = min(c0 + panel, n)
            for j in reversed(range(c0, c1)):  # warp 0, one shuffle a step
                xj = z[:, j] * rd[:, j]
                z[:, c0:j] -= S[:, j, c0:j] * xj[:, None]
            x_panel = z[:, c0:c1] * rd[:, c0:c1]
            for j in reversed(range(c0, c1)):  # every thread, a z entry each
                z[:, :c0] -= S[:, j, :c0] * x_panel[:, j - c0, None]
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


@pytest.mark.parametrize("branch,scratch", [("global", False),
                                            ("global", True),
                                            ("block", False)])
def test_refused_launch_names_branch_and_n(monkeypatch, branch, scratch):
    """What the wrapper raises when the launcher refuses: the branch, n,
    the batch and the type beside the CUDA error's text, and on the global
    branch its cluster and the scratch (the launcher refuses a null one)."""
    monkeypatch.setattr(tlinalg, "_ERROR_STRING",
                        lambda err: b"invalid argument")
    msg = tlinalg.launch_error(1, branch, 254, 4, torch.float64, scratch)
    assert f"the {branch} kernel at n = 254, B = 4, torch.float64" in msg
    assert msg.endswith("CUDA error 1, invalid argument")
    assert ("thread-block cluster" in msg) == (branch == "global")
    assert ("no scratch" in msg) == (branch == "global" and not scratch)


def test_build_without_nvcc_says_what_is_missing(monkeypatch):
    from dm_control_torch.ops import _cuda_build

    monkeypatch.setattr(_cuda_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.nvcc_path()


#: n on both sides of the global kernel's start (203 in float64, 304 in
#: float32), a HUMANOID 2v2 match's nv (254), an ANT 11v11 match's (314), a
#: HUMANOID 3v3 match's (378) and one past a panel (321)
_GLOBAL_NS = [161, 203, 254, 304, 314, 321, 378]
_GLOBAL_CASES = [(n, dtype) for n in _GLOBAL_NS
                 for dtype in (np.float32, np.float64)]


@functools.lru_cache(maxsize=None)
def _global_case(n, dtype):
    """Four seeded systems, one not positive definite, and the same matrices
    with junk above the diagonal; the global algorithm's x of the junk."""
    rng = np.random.default_rng(600 + n)
    b, bad = 4, 2
    a = _spd(rng, b, n, dtype)
    a = (a + np.swapaxes(a, 1, 2)) / 2
    a[bad] = -a[bad]
    rhs = rng.standard_normal((b, n)).astype(dtype)
    junk = np.tril(a) + np.triu(rng.standard_normal((b, n, n)), 1).astype(
        dtype)
    x = _global_algorithm(junk, rhs)
    assert np.isnan(x[bad]).all()
    good = np.arange(b) != bad
    assert np.isfinite(x[good]).all()
    return a, rhs, x, bad, good


@pytest.mark.parametrize("n,dtype", _GLOBAL_CASES)
def test_global_algorithm_matches_plain_version(n, dtype):
    a, rhs, x, bad, good = _global_case(n, dtype)
    ref = _torch(a, rhs)
    assert np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@pytest.mark.parametrize("n,dtype", _GLOBAL_CASES)
def test_global_algorithm_matches_xla(n, dtype):
    a, rhs, x, bad, good = _global_case(n, dtype)
    ref = np.asarray(jlinalg._xla_chol_solve(jnp.asarray(a),
                                             jnp.asarray(rhs)))
    assert ref.dtype == dtype and np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=_TOL[dtype],
                               atol=_TOL[dtype])


@pytest.mark.parametrize("n,panel", [(11, 4)])
def test_global_algorithm_matches_pallas_interpret(n, panel):
    """Panels narrow enough that several run, against the Pallas kernel in
    interpret mode (float32 only; its NaN for a pivot that is not > 0 stays
    in that system's lane)."""
    a, rhs, _, bad, good = _algorithm_case(n, np.float32)
    x = _global_algorithm(a, rhs, panel)
    ref = np.asarray(jlinalg._pallas_chol_solve(
        jnp.asarray(a), jnp.asarray(rhs), interpret=True))
    assert np.isnan(x[bad]).all() and np.isnan(ref[bad]).all()
    np.testing.assert_allclose(x[good], ref[good], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_global_algorithm_takes_the_block_kernels_order(dtype):
    """Same factor, and each z entry of the back substitution takes its
    terms in the same order: the two kernels' algorithms agree bit for
    bit."""
    rng = np.random.default_rng(700)
    a = _spd(rng, 3, 97, dtype)
    rhs = rng.standard_normal((3, 97)).astype(dtype)
    np.testing.assert_array_equal(_global_algorithm(a, rhs),
                                  _block_algorithm(a, rhs))
