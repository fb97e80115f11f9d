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
``csrc/chol_solve.cu`` or raises; a CPU tensor uses
``chol_solve_reference``, the plain PyTorch version of the same function.
The kernel takes one of three branches, fixed on (n, type)
(``kernel_branch``): "register" (one warp a system, n <= 32, and 64 in
float32), "block" (one thread block a system, the triangle in shared
memory: up to n = 202 in float64 and 303 in float32) and "global" (a
thread-block cluster a system, 16 CTAs for a few systems on an H100
(``cluster_ctas``), the triangle in a scratch tensor that the wrapper
allocates, every larger n up to ``chol_solve_max_n()``).
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
_BLOCK_MAX_N = {}  # {dtype: largest n of the block kernel}
_SCRATCH_ELEMS = None  # n -> scratch elements a system on the global branch
_LIB = None
_ERROR_STRING = None


def _load() -> None:
    """Builds (or loads) the library and resolves its entry points once."""
    global _ENTRY, _MAX_N, _REGISTER_MAX_N, _BLOCK_MAX_N, _SCRATCH_ELEMS
    global _LIB, _ERROR_STRING
    from dm_control_torch.ops import _cuda_build

    lib = _cuda_build.load_library("chol_solve.cu")
    ptr = ctypes.c_void_p
    for fn in (lib.chol_solve_f32, lib.chol_solve_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ptr]
        fn.restype = ctypes.c_int
    lib.chol_solve_max_n.argtypes = []
    lib.chol_solve_max_n.restype = ctypes.c_int
    for fn in (lib.chol_solve_cluster_ctas,
               lib.chol_solve_global_active_clusters):
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    for fn in (lib.chol_solve_register_max_n, lib.chol_solve_block_max_n):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.chol_solve_scratch_elems.argtypes = [ctypes.c_int]
    lib.chol_solve_scratch_elems.restype = ctypes.c_longlong
    _SCRATCH_ELEMS = lib.chol_solve_scratch_elems
    lib.chol_solve_error_string.argtypes = [ctypes.c_int]
    lib.chol_solve_error_string.restype = ctypes.c_char_p
    _ERROR_STRING = lib.chol_solve_error_string
    _MAX_N = lib.chol_solve_max_n()
    _LIB = lib
    _REGISTER_MAX_N = {
        dtype: lib.chol_solve_register_max_n(int(dtype == torch.float64))
        for dtype in _DTYPES}
    _BLOCK_MAX_N = {
        dtype: lib.chol_solve_block_max_n(int(dtype == torch.float64))
        for dtype in _DTYPES}
    _ENTRY = {torch.float32: lib.chol_solve_f32,
              torch.float64: lib.chol_solve_f64}


def build() -> None:
    """Builds (or loads) the CUDA library now rather than on first use."""
    if _ENTRY is None:
        _load()


def _ask(name: str, dtype: torch.dtype, arg: int, what: str) -> int:
    """Calls the library's ``name(is_f64, arg, &err)``; raises on an
    error."""
    build()
    err = ctypes.c_int(0)
    value = getattr(_LIB, name)(int(dtype == torch.float64), arg,
                                ctypes.byref(err))
    if err.value != 0:
        raise RuntimeError(f"chol_solve: {what} could not be counted: "
                           + _ERROR_STRING(err.value).decode())
    return value


def cluster_ctas(dtype: torch.dtype, batch: int) -> int:
    """CTAs of the thread-block cluster that solves one system on the
    global branch at this batch on the current card: 16 for a few systems
    on an H100, halved while the card cannot hold the batch's clusters at
    once."""
    return _ask("chol_solve_cluster_ctas", dtype, batch,
                "the cluster's CTAs")


def global_active_clusters(dtype: torch.dtype, ctas: int) -> int:
    """Clusters of ``ctas`` CTAs of the global kernel that the current
    card holds at once: the systems of that branch in flight."""
    return _ask("chol_solve_global_active_clusters", dtype, ctas,
                "the card's clusters")


def launch_error(err: int, branch: str, n: int, batch: int,
                 dtype: torch.dtype, scratch: bool) -> str:
    """What a refused launch says: the branch, n, the batch and the type,
    and on the global branch that it launches a thread-block cluster a
    system and whether a scratch was given, beside the CUDA error's own
    text."""
    where = f"the {branch} kernel at n = {n}, B = {batch}, {dtype}"
    if branch == "global":
        where += (" (a thread-block cluster a system; "
                  + ("scratch given" if scratch else "no scratch: the "
                     "global kernel keeps its triangle there") + ")")
    return (f"chol_solve: {where} was not launched: CUDA error {err}, "
            + _ERROR_STRING(err).decode())


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
        raise ValueError(f"chol_solve_cuda supports 1 <= n <= {_MAX_N} "
                         f"(chol_solve_max_n()), got n = {n}")
    return n


def chol_solve_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launches the fused factor+solve kernel on the current stream.

    a: (B, n, n), or one (n, n) matrix shared by the batch (the kernel
    reads it with a batch stride of 0, nothing is copied); b: (B, n);
    both contiguous, float32 or float64, on one CUDA device.  Only the
    lower triangle of a is read, as by ``chol_solve_reference``.  Returns
    x (B, n).  Raises on anything else, and where the launch is refused
    (``launch_error`` names the branch and n).  On the global branch the
    packed triangle of each system lives in a scratch tensor allocated here
    (B x ``chol_solve_scratch_elems(n)`` elements), and each system is
    solved by a thread-block cluster.  Counts the launch in
    ``chol_solve.launches`` and in ``chol_solve.branch_launches`` under the
    branch that (n, type) takes.
    """
    n = _check(a, b)
    branch = kernel_branch(n, a.dtype)
    x = torch.empty_like(b)
    device = a.device
    scratch = (torch.empty(b.shape[0] * _SCRATCH_ELEMS(n), dtype=b.dtype,
                           device=device)
               if branch == "global" else None)
    args = (a.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b.shape[0], n,
            0 if a.ndim == 2 else n * n,
            torch.cuda.current_stream(device).cuda_stream)
    if device.index == torch.cuda.current_device():
        err = _ENTRY[a.dtype](*args)
    else:  # a launch goes to the current device: make it a's
        with torch.cuda.device(device):
            err = _ENTRY[a.dtype](*args)
    if err != 0:
        raise RuntimeError(launch_error(err, branch, n, b.shape[0], a.dtype,
                                        scratch is not None))
    chol_solve.launches += 1
    chol_solve.branch_launches[branch] += 1
    return x


def kernel_branch(n: int, dtype: torch.dtype) -> str:
    """The branch of the launcher's rule, fixed on (n, type), that a solve
    of size n takes: "register" (n <= 32, and n <= 64 in float32; a warp a
    system), "block" (up to the largest n whose triangle fits one block's
    shared memory: 202 in float64, 303 in float32; a thread block a system)
    or "global" (a thread-block cluster a system, the triangle in device
    memory)."""
    if _ENTRY is None:
        _load()
    if n <= _REGISTER_MAX_N[dtype]:
        return "register"
    return "block" if n <= _BLOCK_MAX_N[dtype] else "global"


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
    if b.shape[-1] == 0:  # no unknowns (a model without dofs): no launch
        return b.clone()
    if a.ndim == 3 and a.stride(0) == 0:
        a = a[0]  # an expanded shared matrix: hand over the one copy
    return chol_solve_cuda(a.contiguous(), b.contiguous())


#: launches of the CUDA kernel since the count was last set to 0
chol_solve.launches = 0
#: the same by branch: "register" (n <= 32, and n <= 64 in float32),
#: "block" (up to n = 202 in float64, 303 in float32) and "global" (every
#: larger n)
chol_solve.branch_launches = {"register": 0, "block": 0, "global": 0}


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
