// Batched fused Cholesky factor + solve for small SPD systems (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_chol_solve` in
// dm_control_tpu/ops/linalg.py.  Solves A x = b for B independent SPD
// systems, A (B, n, n) row-major (or one (n, n) matrix shared by the batch,
// passed with a batch stride of 0), b and x (B, n).  The factor never
// reaches device memory.
//
// What bounds it on an H100.  At the engine's shapes (n = 27, B = 1024,
// float32) a call must move 3.2 MB (A read once, b read once, x written
// once): 0.96 us at 3.35 TB/s.  Its 8 MFLOP are 0.1 us of float32 rate.
// So bytes set the bound, and what stands between the kernel and that
// bound is latency: a factorization is a chain of n dependent pivot steps,
// a substitution another n, and at B = 1024 an SM holds only about 8
// systems whose chains can overlap.
//
// Design, n <= 32 (and n <= 64 in float32): one warp per system, the
// matrix in registers, data exchanged by warp shuffles.
//  - Lane k holds column k of the symmetric matrix in a register array
//    that is indexed only by unrolled loop counters.  No shared memory, no
//    __syncwarp, no read-modify-write round trip per step.
//  - Step j is right-looking: every lane reads column j from lane j with
//    one __shfl_sync per entry and subtracts entry * f from its own
//    column, f = S[j][k] / pivot, one FMA per entry.  Because the lane
//    holds the whole column, S[j][k] = S[k][j] is its own register: no
//    select out of the broadcast.  Every lane does n - j - 1 FMAs at step
//    j; no lane runs a triangle of serial loops.
//  - The factor is the square-root-free form A = L D L^T (L unit lower,
//    D the pivots, which are the squares of the Cholesky diagonal, so the
//    positive-definite test is the same).  It takes the square root and
//    one shuffle off every link of the chain: the broadcast of column j
//    does not wait for the pivot's reciprocal, only the multiplier f does.
//    Per step the chain is shuffle -> reciprocal -> multiply -> FMA.  The
//    reciprocal is IEEE (__frcp_rn, and 1.0 / p in float64); there is no
//    division anywhere else.
//  - Forward substitution is free: b rides along as one more row of the
//    matrix (one more register per lane) and the same updates leave
//    z = L^-1 b in it.
//  - Back substitution L^T x = D^-1 z needs S[i][k], i > k, which is lane
//    k's own column: for i = n-1 .. 0 one shuffle broadcasts x[i] and
//    every lane k < i does one FMA; lane k finishes with one multiply by
//    its stored reciprocal pivot.
//  - A runtime n below the register bound N (32, or 64 with two columns
//    per lane) is placed at the END of the N x N frame: rows and columns
//    shift by N - n, and steps j < N - n are skipped by one uniform branch
//    each, so no step does work on padding.
//  - Loads: only the lower triangle of A is read, as the plain version
//    (a LAPACK-style lower Cholesky) reads it; what stands above the
//    diagonal is never touched.  Lane k takes its column's entries at and
//    below the diagonal from consecutive addresses, and those above it
//    from row k (the transposed lower triangle: lines that the first kind
//    of load brings into L1 anyway).  All loads are requested before the
//    first use; x is written once, coalesced.  No more than the bound's
//    bytes come from device memory.
//
// n above the register path (n > 32 in float64, n > 64 in float32, up to
// 160) keeps the earlier design: one warp per system with the matrix in
// shared memory, lanes over rows, __syncwarp between the passes.
//
// Pivots: a pivot that is not > 0 (or not finite) marks the system as not
// positive definite and its whole row of x is written as NaN, as
// jnp.linalg.cholesky gives; other systems are untouched.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see dm_control_torch/ops/_cuda_build.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 4;

// Shared-memory path (n above the register path).  Leading dimension of
// the shared copy of A: odd, so that lanes walking a
// column (stride ld) fall in distinct banks.
__host__ __device__ inline int padded_ld(int n) { return n | 1; }

__device__ inline float root(float v) { return sqrtf(v); }
__device__ inline double root(double v) { return ::sqrt(v); }

template <typename T>
__global__ void chol_solve_smem_kernel(const T* __restrict__ a,
                                       const T* __restrict__ b,
                                       T* __restrict__ x, int batch, int n,
                                       long long a_stride,
                                       int warps_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int sys = blockIdx.x * warps_per_block + warp;
  if (sys >= batch) return;  // whole warp leaves together

  const int ld = padded_ld(n);
  T* A = smem + warp * (n * ld + n);  // this warp's matrix
  T* v = A + n * ld;                   // rhs, overwritten by y then x

  // Load the lower triangle (with the diagonal) of A and all of b,
  // coalesced over the contiguous n * n block.
  const T* ga = a + sys * a_stride;
  for (int e = lane; e < n * n; e += kWarp) {
    const int i = e / n, k = e % n;
    if (k <= i) A[i * ld + k] = ga[e];
  }
  const T* gb = b + static_cast<long long>(sys) * n;
  for (int i = lane; i < n; i += kWarp) v[i] = gb[i];
  __syncwarp();

  // Right-looking factorization in place: after step j, column j holds
  // L[:, j] and the trailing lower triangle holds the Schur complement.
  bool bad = false;
  for (int j = 0; j < n; ++j) {
    const T s = A[j * ld + j];
    // every lane reads the same pivot, so `bad` is warp-uniform; s - s is
    // 0 only for a finite s
    if (!(s > T(0)) || !(s - s == T(0))) bad = true;
    const T d = root(s);
    __syncwarp();
    if (lane == 0) A[j * ld + j] = d;
    for (int i = j + 1 + lane; i < n; i += kWarp) A[i * ld + j] /= d;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += kWarp) {
      const T lij = A[i * ld + j];
      for (int k = j + 1; k <= i; ++k) A[i * ld + k] -= lij * A[k * ld + j];
    }
    __syncwarp();
  }

  // Forward substitution L y = b, column-oriented: y[j] is final once the
  // updates from columns < j have landed.
  for (int j = 0; j < n; ++j) {
    const T yj = v[j] / A[j * ld + j];
    __syncwarp();
    if (lane == 0) v[j] = yj;
    for (int i = j + 1 + lane; i < n; i += kWarp) v[i] -= A[i * ld + j] * yj;
    __syncwarp();
  }
  // Back substitution L^T x = y, row i of L gives column i of L^T.
  for (int i = n - 1; i >= 0; --i) {
    const T xi = v[i] / A[i * ld + i];
    __syncwarp();
    if (lane == 0) v[i] = xi;
    for (int k = lane; k < i; k += kWarp) v[k] -= A[i * ld + k] * xi;
    __syncwarp();
  }

  T* gx = x + static_cast<long long>(sys) * n;
  const T nan = T(NAN);
  for (int i = lane; i < n; i += kWarp) gx[i] = bad ? nan : v[i];
}

// Warps (systems) per block of the register kernel.  1, 2, 4 and 8 timed
// within 3% of each other at B = 1024, n = 27 (H100, 700 W).
constexpr int kRegWarps = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ inline float recip(float v) { return __frcp_rn(v); }
__device__ inline double recip(double v) { return 1.0 / v; }

// Register path: one warp per system, C columns per lane, n <= 32 * C.
// Physical index p = logical index + (N - n); lane p % 32 holds column p in
// col[p / 32][.].  Every loop below is fully unrolled, so col is indexed
// by constants and stays in registers.
template <typename T, int C>
__global__ void __launch_bounds__(kRegWarps * kWarp)
    chol_solve_reg_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          T* __restrict__ x, int batch, int n,
                          long long a_stride) {
  constexpr int N = C * kWarp;
  const int lane = threadIdx.x % kWarp;
  const int sys = blockIdx.x * kRegWarps + threadIdx.x / kWarp;
  if (sys >= batch) return;  // whole warp leaves together
  const int s = N - n;       // first physical index that holds data

  const T* ga = a + sys * a_stride;
  const T* gb = b + static_cast<long long>(sys) * n;
  T col[C][N];  // col[c][i] = S[i][column lane + 32 c]
  T rhs[C];     // b as row n of the matrix: becomes z, then x
  T rd[C];      // reciprocal pivot of the lane's own column
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int q = lane + c * kWarp - s;  // logical column, < 0 in padding
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = i - s;  // logical row; (r, q) above the diagonal is
                            // taken from (q, r) of the lower triangle
      col[c][i] = (r >= 0 && q >= 0) ? ga[r >= q ? r * n + q : q * n + r]
                                     : T(0);
    }
    rhs[c] = q >= 0 ? gb[q] : T(0);
    rd[c] = T(0);
  }

  // Factor S = L D L^T, right-looking.  After step j lane j's column is
  // frozen: col[.][j] = D[j] and col[.][i] = L[i][j] D[j] for i > j.
  bool bad = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j >= s) {  // uniform: skips the padding
      const int cj = j / kWarp, oj = j % kWarp;
      const T p = __shfl_sync(kFullMask, col[cj][j], oj);
      // warp-uniform; p - p is 0 only for a finite p
      if (!(p > T(0)) || !(p - p == T(0))) bad = true;
      const T rp = recip(p);
      if (lane == oj) rd[cj] = rp;
      T f[C];  // S[j][k] / D[j] for the lane's columns k > j, else 0
#pragma unroll
      for (int c = cj; c < C; ++c)
        f[c] = (lane + c * kWarp > j) ? col[c][j] * rp : T(0);
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        const T v = __shfl_sync(kFullMask, col[cj][i], oj);
#pragma unroll
        for (int c = cj; c < C; ++c) col[c][i] -= v * f[c];
      }
      const T vb = __shfl_sync(kFullMask, rhs[cj], oj);
#pragma unroll
      for (int c = cj; c < C; ++c) rhs[c] -= vb * f[c];
    }
  }

  // Back substitution L^T x = D^-1 z from the lane's own column.
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    if (j >= s) {
      const int cj = j / kWarp, oj = j % kWarp;
      const T xj = __shfl_sync(kFullMask, rhs[cj] * rd[cj], oj);
#pragma unroll
      for (int c = 0; c <= cj; ++c)
        if (lane + c * kWarp < j) rhs[c] -= col[c][j] * xj;
    }
  }

  T* gx = x + static_cast<long long>(sys) * n;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int q = lane + c * kWarp - s;
    if (q >= 0) gx[q] = bad ? T(NAN) : rhs[c] * rd[c];
  }
}

template <typename T>
size_t smem_per_warp(int n) {
  return static_cast<size_t>(n * padded_ld(n) + n) * sizeof(T);
}

template <typename T, int C>
int launch_reg(const T* a, const T* b, T* x, int batch, int n,
               long long a_stride, cudaStream_t stream) {
  const int blocks = (batch + kRegWarps - 1) / kRegWarps;
  chol_solve_reg_kernel<T, C><<<blocks, kRegWarps * kWarp, 0, stream>>>(
      a, b, x, batch, n, a_stride);
  return cudaGetLastError();
}

template <typename T>
int launch_smem(const T* a, const T* b, T* x, int batch, int n,
                long long a_stride, cudaStream_t stream) {
  const size_t per_warp = smem_per_warp<T>(n);
  int warps = kMaxWarpsPerBlock;
  // keep a block inside the 48 KB that needs no opt-in where possible
  while (warps > 1 && per_warp * warps > 48 * 1024) --warps;
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_smem_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + warps - 1) / warps;
  chol_solve_smem_kernel<T><<<blocks, warps * kWarp, smem, stream>>>(
      a, b, x, batch, n, a_stride, warps);
  return cudaGetLastError();
}

// The rule, fixed on (n, type):
//   n <= 32                 register kernel, one column per lane;
//   32 < n <= 64, float32   register kernel, two columns per lane
//                           (in float64 two columns are 256 registers a
//                           thread, more than the card has);
//   otherwise               shared-memory kernel.
int launch(const float* a, const float* b, float* x, int batch, int n,
           long long a_stride, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  if (n <= kWarp)
    return launch_reg<float, 1>(a, b, x, batch, n, a_stride, stream);
  if (n <= 2 * kWarp)
    return launch_reg<float, 2>(a, b, x, batch, n, a_stride, stream);
  return launch_smem<float>(a, b, x, batch, n, a_stride, stream);
}

int launch(const double* a, const double* b, double* x, int batch, int n,
           long long a_stride, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  if (n <= kWarp)
    return launch_reg<double, 1>(a, b, x, batch, n, a_stride, stream);
  return launch_smem<double>(a, b, x, batch, n, a_stride, stream);
}

}  // namespace

extern "C" {

// Largest n whose one-warp block fits the card's 227 KB of shared memory
// in float64 (n = 160 needs 206 KB).
int chol_solve_max_n() { return 160; }

// a_stride: elements between the matrices of consecutive systems, n * n
// for a (B, n, n) batch, 0 for one matrix shared by all systems.
int chol_solve_f32(const float* a, const float* b, float* x, int batch,
                   int n, long long a_stride, void* stream) {
  return launch(a, b, x, batch, n, a_stride,
                static_cast<cudaStream_t>(stream));
}

int chol_solve_f64(const double* a, const double* b, double* x, int batch,
                   int n, long long a_stride, void* stream) {
  return launch(a, b, x, batch, n, a_stride,
                static_cast<cudaStream_t>(stream));
}

const char* chol_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
