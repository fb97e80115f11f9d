"""Batched small-matrix Cholesky solve: the engine's one hand-written kernel.

Counterpart of ``dm_control_tpu/ops/linalg.py``.  The engine's three dense
solves on every substep all factor one SPD matrix of size nv x nv per
environment and solve one right-hand side:

- ``M qacc_smooth = qfrc_smooth`` (``physics/inertia.py::solve_m``);
- the Newton direction ``H p = -g`` (``physics/solver.py``);
- the implicit-damping Euler step ``(M + h diag(B)) v' = f``
  (``physics/engine.py::euler``).

``chol_solve(a, b)`` takes a (B, n, n) and b (B, n) (a may also be one
(n, n) matrix shared by the batch) and dispatches on the device of its
inputs: a CUDA tensor launches the fused factor+solve kernel in
``csrc/chol_solve.cu`` or raises; a CPU tensor uses
``chol_solve_reference``, the plain PyTorch version of the same function.
``reference_solves()`` is the one explicit switch that sends CUDA tensors
to the plain version too, so that a whole step can be compared on the card
with and without the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

_USE_REFERENCE_ON_CUDA = False


def chol_solve_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch x = a^-1 b through a Cholesky factor.

    A system whose matrix is not positive definite gets NaN in its whole
    row of x (``torch.linalg.cholesky`` would raise for the whole batch;
    ``jnp.linalg.cholesky`` and the kernel give NaN), so one diverged
    environment stays in its own row.
    """
    L, info = torch.linalg.cholesky_ex(a)
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                      upper=True).squeeze(-1)
    bad = (info > 0).unsqueeze(-1)
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _lib():
    from dm_control_torch.ops import _cuda_build

    lib = _cuda_build.load_library("chol_solve.cu")
    if not hasattr(lib, "max_n"):
        ptr = ctypes.c_void_p
        for fn in (lib.chol_solve_f32, lib.chol_solve_f64):
            fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ptr]
            fn.restype = ctypes.c_int
        lib.chol_solve_max_n.argtypes = []
        lib.chol_solve_max_n.restype = ctypes.c_int
        lib.chol_solve_error_string.argtypes = [ctypes.c_int]
        lib.chol_solve_error_string.restype = ctypes.c_char_p
        lib.max_n = lib.chol_solve_max_n()
    return lib


def build() -> None:
    """Builds (or loads) the CUDA library now rather than on first use."""
    _lib()


def chol_solve_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launches the fused factor+solve kernel on the current stream.

    a: (B, n, n) and b: (B, n), contiguous, float32 or float64, on one
    CUDA device.  Returns x (B, n).  Raises on anything else.
    """
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"chol_solve_cuda needs a and b on one CUDA device, "
                         f"got {a.device} and {b.device}")
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise TypeError(f"chol_solve_cuda takes float32 or float64, got "
                        f"{a.dtype} and {b.dtype}")
    if a.ndim != 3 or a.shape[1] != a.shape[2] or b.shape != a.shape[:2]:
        raise ValueError(f"chol_solve_cuda needs a (B, n, n) and b (B, n), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("chol_solve_cuda needs contiguous inputs")
    lib = _lib()
    batch, n = b.shape
    if n < 1 or n > lib.max_n:
        raise ValueError(f"chol_solve_cuda supports 1 <= n <= {lib.max_n}, "
                         f"got n = {n}")
    x = torch.empty_like(b)
    fn = lib.chol_solve_f32 if a.dtype == torch.float32 else \
        lib.chol_solve_f64
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), batch, n, stream)
    if err != 0:
        raise RuntimeError("chol_solve kernel launch failed: "
                           + lib.chol_solve_error_string(err).decode())
    chol_solve.launches += 1
    return x


def chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves the SPD systems ``a @ x = b``: a (B, n, n) or (n, n),
    b (B, n).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (or the plain version inside ``reference_solves()``)."""
    if a.device.type == "cpu":
        return chol_solve_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"chol_solve: unsupported device {a.device}")
    if _USE_REFERENCE_ON_CUDA:
        return chol_solve_reference(a, b)
    if a.ndim == 2:
        a = a.expand(b.shape[0], *a.shape)
    return chol_solve_cuda(a.contiguous(), b.contiguous())


#: launches of the CUDA kernel since the count was last set to 0
chol_solve.launches = 0


@contextlib.contextmanager
def reference_solves():
    """Within this block, CUDA tensors also take ``chol_solve_reference``
    (for comparing a whole step with and without the kernel)."""
    global _USE_REFERENCE_ON_CUDA
    old = _USE_REFERENCE_ON_CUDA
    _USE_REFERENCE_ON_CUDA = True
    try:
        yield
    finally:
        _USE_REFERENCE_ON_CUDA = old
