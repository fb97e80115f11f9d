"""Batched small-matrix Cholesky solve: the engine's one hand-written kernel.

Counterpart of ``dm_control_tpu/ops/linalg.py``.  The engine's three dense
solves on every substep all factor one SPD matrix of size nv x nv per
environment and solve one right-hand side:

- ``M qacc_smooth = qfrc_smooth`` (``physics/inertia.py::solve_m``);
- the Newton direction ``H p = -g`` (``physics/solver.py``);
- the implicit-damping Euler step ``(M + h diag(B)) v' = f``
  (``physics/engine.py::euler``).

``chol_solve(a, b)`` takes a (B, n, n) and b (B, n) (a may also be one
(n, n) matrix shared by the batch, which is never copied B times) and
dispatches on the device of its
inputs: a CUDA tensor launches the fused factor+solve kernel in
``csrc/chol_solve.cu`` or raises (the register kernel, one warp a system,
up to n = 32, and 64 in float32; the block kernel, one thread block a
system, above that up to 160); a CPU tensor uses
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


_DTYPES = (torch.float32, torch.float64)
_ENTRY = None  # {dtype: C entry point}, filled by the first _load()
_MAX_N = 0
_REGISTER_MAX_N = {}  # {dtype: largest n of the register kernel}
_ERROR_STRING = None


def _load() -> None:
    """Builds (or loads) the library and resolves its entry points once."""
    global _ENTRY, _MAX_N, _REGISTER_MAX_N, _ERROR_STRING
    from dm_control_torch.ops import _cuda_build

    lib = _cuda_build.load_library("chol_solve.cu")
    ptr = ctypes.c_void_p
    for fn in (lib.chol_solve_f32, lib.chol_solve_f64):
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ptr]
        fn.restype = ctypes.c_int
    lib.chol_solve_max_n.argtypes = []
    lib.chol_solve_max_n.restype = ctypes.c_int
    lib.chol_solve_register_max_n.argtypes = [ctypes.c_int]
    lib.chol_solve_register_max_n.restype = ctypes.c_int
    lib.chol_solve_error_string.argtypes = [ctypes.c_int]
    lib.chol_solve_error_string.restype = ctypes.c_char_p
    _ERROR_STRING = lib.chol_solve_error_string
    _MAX_N = lib.chol_solve_max_n()
    _REGISTER_MAX_N = {
        dtype: lib.chol_solve_register_max_n(int(dtype == torch.float64))
        for dtype in _DTYPES}
    _ENTRY = {torch.float32: lib.chol_solve_f32,
              torch.float64: lib.chol_solve_f64}


def build() -> None:
    """Builds (or loads) the CUDA library now rather than on first use."""
    if _ENTRY is None:
        _load()


def _check(a: torch.Tensor, b: torch.Tensor) -> int:
    """The kernel's conditions, each tested once; returns n."""
    if not a.is_cuda or b.device != a.device:
        raise ValueError(f"chol_solve_cuda needs a and b on one CUDA device, "
                         f"got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"chol_solve_cuda takes float32 or float64, got "
                        f"{a.dtype} and {b.dtype}")
    if (b.ndim != 2 or a.ndim not in (2, 3)
            or a.shape[-2:] != (b.shape[1], b.shape[1])
            or (a.ndim == 3 and a.shape[0] != b.shape[0])):
        raise ValueError(f"chol_solve_cuda needs a (B, n, n) or (n, n) and "
                         f"b (B, n), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("chol_solve_cuda needs contiguous inputs")
    if _ENTRY is None:
        _load()
    n = b.shape[1]
    if not 1 <= n <= _MAX_N:
        raise ValueError(f"chol_solve_cuda supports 1 <= n <= {_MAX_N}, got "
                         f"n = {n}")
    return n


def chol_solve_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launches the fused factor+solve kernel on the current stream.

    a: (B, n, n), or one (n, n) matrix shared by the batch (the kernel
    reads it with a batch stride of 0, nothing is copied); b: (B, n);
    both contiguous, float32 or float64, on one CUDA device.  Only the
    lower triangle of a is read, as by ``chol_solve_reference``.  Returns
    x (B, n).  Raises on anything else.  Counts the launch in
    ``chol_solve.launches`` and in ``chol_solve.branch_launches`` under the
    branch that (n, type) takes.
    """
    n = _check(a, b)
    x = torch.empty_like(b)
    device = a.device
    args = (a.data_ptr(), b.data_ptr(), x.data_ptr(), b.shape[0], n,
            0 if a.ndim == 2 else n * n,
            torch.cuda.current_stream(device).cuda_stream)
    if device.index == torch.cuda.current_device():
        err = _ENTRY[a.dtype](*args)
    else:  # a launch goes to the current device: make it a's
        with torch.cuda.device(device):
            err = _ENTRY[a.dtype](*args)
    if err != 0:
        raise RuntimeError("chol_solve kernel launch failed: "
                           + _ERROR_STRING(err).decode())
    chol_solve.launches += 1
    chol_solve.branch_launches[kernel_branch(n, a.dtype)] += 1
    return x


def kernel_branch(n: int, dtype: torch.dtype) -> str:
    """The branch of the launcher's rule, fixed on (n, type), that a solve
    of size n takes: "register" (n <= 32, and n <= 64 in float32) or
    "block"."""
    if _ENTRY is None:
        _load()
    return "register" if n <= _REGISTER_MAX_N[dtype] else "block"


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
    if a.ndim == 3 and a.stride(0) == 0:
        a = a[0]  # an expanded shared matrix: hand over the one copy
    return chol_solve_cuda(a.contiguous(), b.contiguous())


#: launches of the CUDA kernel since the count was last set to 0
chol_solve.launches = 0
#: the same by branch: "register" (n <= 32, and n <= 64 in float32) and
#: "block" (every larger n up to 160)
chol_solve.branch_launches = {"register": 0, "block": 0}


def reset_launch_counts() -> None:
    """Sets ``chol_solve.launches`` and each branch's count to 0."""
    chol_solve.launches = 0
    for branch in chol_solve.branch_launches:
        chol_solve.branch_launches[branch] = 0


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
