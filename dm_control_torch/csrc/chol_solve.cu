// Batched fused Cholesky factor + solve for small SPD systems (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `_pallas_chol_solve` in
// dm_control_tpu/ops/linalg.py.  Solves A x = b for B independent SPD
// systems, A (B, n, n) row-major, b and x (B, n).  The factor L never
// leaves shared memory.
//
// What bounds it on an H100: at the engine's shapes (n = 27, B = 1024,
// float32) a call moves about 3 MB (A is read once, b read and x written
// once), about 1 us of HBM time at 3.35 TB/s, and does about 7 MFLOP.
// So it is bound by latency: the column-by-column recurrence is a chain
// of n dependent steps per system, and the launch itself costs a few us.
// The design answers that by giving each system one warp and keeping the
// whole recurrence in shared memory: lanes run over rows, so every step of
// the chain is one warp-synchronous pass with no block-wide barrier, and
// the batch fills the card with independent warps (B = 1024 gives 1024
// warps in 256 blocks on 132 SMs).  The TPU kernel's (8, 128) lane layout
// and its pad-to-1024 batch are not carried over.
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

// Leading dimension of the shared copy of A: odd, so that lanes walking a
// column (stride ld) fall in distinct banks.
__host__ __device__ inline int padded_ld(int n) { return n | 1; }

__device__ inline float root(float v) { return sqrtf(v); }
__device__ inline double root(double v) { return ::sqrt(v); }

template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b,
                                  T* __restrict__ x, int batch, int n,
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
  const T* ga = a + static_cast<long long>(sys) * n * n;
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

template <typename T>
size_t smem_per_warp(int n) {
  return static_cast<size_t>(n * padded_ld(n) + n) * sizeof(T);
}

template <typename T>
int launch(const T* a, const T* b, T* x, int batch, int n,
           cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  const size_t per_warp = smem_per_warp<T>(n);
  int warps = kMaxWarpsPerBlock;
  // keep a block inside the 48 KB that needs no opt-in where possible
  while (warps > 1 && per_warp * warps > 48 * 1024) --warps;
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + warps - 1) / warps;
  chol_solve_kernel<T><<<blocks, warps * kWarp, smem, stream>>>(
      a, b, x, batch, n, warps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest n whose one-warp block fits the card's 227 KB of shared memory
// in float64 (n = 160 needs 206 KB).
int chol_solve_max_n() { return 160; }

int chol_solve_f32(const float* a, const float* b, float* x, int batch,
                   int n, void* stream) {
  return launch<float>(a, b, x, batch, n,
                       static_cast<cudaStream_t>(stream));
}

int chol_solve_f64(const double* a, const double* b, double* x, int batch,
                   int n, void* stream) {
  return launch<double>(a, b, x, batch, n,
                        static_cast<cudaStream_t>(stream));
}

const char* chol_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
