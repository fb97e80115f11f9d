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
// Both kernels factor S = L D L^T, square-root free (L unit lower, D the
// pivots, which are the squares of the Cholesky diagonal, so the
// positive-definite test is the same), with one IEEE reciprocal per pivot
// (__frcp_rn, and 1.0 / p in float64) and no division or square root
// anywhere else.  b rides along as row n of the matrix, so the factor's
// updates leave z = L^-1 b in it, and x solves L^T x = D^-1 z.
//
// Register kernel, n <= 32 (and n <= 64 in float32): one warp per system,
// the matrix in registers, data exchanged by warp shuffles.
//  - Lane k holds column k of the symmetric matrix in a register array
//    that is indexed only by unrolled loop counters.  No shared memory, no
//    __syncwarp, no read-modify-write round trip per step.
//  - Step j is right-looking: every lane reads column j from lane j with
//    one __shfl_sync per entry and subtracts entry * f from its own
//    column, f = S[j][k] / pivot, one FMA per entry.  Because the lane
//    holds the whole column, S[j][k] = S[k][j] is its own register: no
//    select out of the broadcast.  Every lane does n - j - 1 FMAs at step
//    j; no lane runs a triangle of serial loops.
//  - The square-root-free form takes the square root and one shuffle off
//    every link of the chain: the broadcast of column j does not wait for
//    the pivot's reciprocal, only the multiplier f does.  Per step the
//    chain is shuffle -> reciprocal -> multiply -> FMA.
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
// Block kernel, every larger n up to 160 (float64 n > 32, float32 n > 64:
// dog's 79 and 85, the rat's 73, the float64 host paths' 38 to 73): one
// thread block of kBlockWarps = 4 warps per system, the matrix in shared
// memory.  Its bound on this card is the same byte bound (2.34 us at
// (512, 85) in float32, nanoseconds at B = 1); what sets its time is the
// chain of n pivot steps, each of which waits on the previous one's
// reciprocal.  It replaces the first shared-memory kernel (one warp per
// system, lanes over rows), which was held back by (1) one warp per
// system, (2) a trailing update in a triangle of serial loops, each FMA a
// shared-memory read-modify-write, (3) a division and a square root on the
// chain, (4) a load of all n^2 entries with a runtime division per
// element, (5) 3n __syncwarp with lane 0 alone writing between them.
// What this design does about each:
//  (1) One block per system: at B = 1 all four warps share the work off
//      the chain (the load, the rows below each diagonal block, the
//      trailing update); at B = 512 a float32 n = 85 block takes 31 KB and
//      72 registers a thread, so seven fit an SM and all 512 systems are
//      in one wave.
//  (2) A blocked right-looking factor with panels of 32 columns.  The
//      diagonal block: warp 0, lane i holding row i of its lower triangle
//      in registers from the current column on (row[0] is the step's
//      entry, so a step is one short loop body, run w times); step j
//      takes the pivot by one shuffle, every lane publishes its entry of
//      column j to a U buffer (S[i][j] = S[j][i]) and, after one
//      __syncwarp, updates its row from it as 16-byte broadcasts while the
//      row shifts down by one.  The rows below: a thread a row solves
//      U_r L11^T = S_r, 32 columns in registers.  The trailing lower
//      triangle, b's row with it: 4 x 4 tiles shared by all threads, each
//      held in registers through the rank-32 update (4 + 4 values read per
//      16 FMAs), written back once.  No loop's length grows with a row
//      index.  Every entry gets its updates in the order of an unblocked
//      right-looking factor.  Three __syncthreads a panel.
//  (3) A = L D L^T, square-root free: one IEEE reciprocal per pivot
//      (__frcp_rn, 1.0 / p in float64; about 80 cycles of the step's
//      latency on this card), no division or square root anywhere else;
//      b rides along as row n, so forward substitution is free; back
//      substitution against D^-1 z.
//  (4) The load: cp.async element by element (a row of A starts on no
//      16-byte boundary for odd n), a warp per row and lanes along it: no
//      integer division, the lower triangle alone.  b and the first
//      panel's 32 rows are one commit group; warps 1-3 then copy the rest
//      while warp 0 factors the first diagonal block.
//  (5) Back substitution by panels, the last first: lane k subtracts what
//      the x of later panels bring through column k of U (rows of U, so
//      consecutive addresses), then for j = w-1 .. 0 one shuffle
//      broadcasts x[j] and each lane below j does one FMA with U[j][k]; x
//      is kept in b's row for the panels before.
//  Layout: the lower triangle packed row by row (row r holds columns 0..r,
//  padded to a multiple of 4 so that rows start on 16 bytes), b as row n,
//  then the panel's L for the trailing update, the diagonal block's L and
//  U, and the reciprocal pivots.  f64 n = 160 takes 155 KB (opted in above
//  48 KB).
//  Tensor cores: none.  In float32 they offer TF32 only, which cannot hold
//  the 2e-4 gate; in float64 the trailing update is at most 1.4 MFLOP a
//  system, a rank-32 SYRK whose time is small beside the pivot chain, so
//  DMMA would move nothing that sets the time.
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

// ---------------------------------------------------------------------------
// Block kernel: one thread block per system (n above the register path).

constexpr int kPanel = kWarp;  // columns a panel: one lane each in warp 0
constexpr int kBlockWarps = 4;
constexpr int kBlockThreads = kBlockWarps * kWarp;
constexpr int kMaxN = 160;

// Offset of row r in the packed lower triangle: row q takes q + 1 entries
// rounded up to 4, so rows 4u .. 4u + 3 take 4u + 4 each and
// sum_{q < 4u + v} = 8u(u + 1) + v(4u + 4).
__host__ __device__ inline int row_off(int r) {
  const int u = r >> 2, v = r & 3;
  return 4 * (u + 1) * (2 * u + v);
}

// Shared memory of one system, in elements; every part starts on a
// multiple of 4 elements (16 bytes).
struct BlockLayout {
  int lb;     // the panel's L, [j][k - c1], row length ld
  int ld;     // covers the widest trailing update's tile columns
  int l11;    // the diagonal block's L, [j][k], 32 x 32
  int ucol;   // the diagonal block's U by columns, kUcol apart
  int rd;     // reciprocal pivots
  int total;
};

constexpr int kUcol = kPanel + 4;  // a column of U and b's entry

__host__ __device__ inline BlockLayout block_layout(int n) {
  BlockLayout l;
  l.lb = row_off(n + 1);  // rows 0..n-1 of A and b as row n
  l.ld = n > kPanel ? ((n - kPanel) & ~3) + 4 : 4;
  l.l11 = l.lb + kPanel * l.ld;
  l.ucol = l.l11 + kPanel * kPanel;
  l.rd = l.ucol + kPanel * kUcol;
  l.total = l.rd + ((n + kPanel - 1) & ~(kPanel - 1));  // whole panels
  return l;
}

template <typename T>
struct Quad {
  T v[4];
};

__device__ inline Quad<float> load4(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
}
__device__ inline Quad<double> load4(const double* p) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  return {{q0.x, q0.y, q1.x, q1.y}};
}
__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// One element from device memory to shared memory without a register.
template <typename T>
__device__ inline void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
__device__ inline void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ inline void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Warp 0: factors the diagonal block of columns c0..c1-1 and b's entries
// c0..c1-1; leaves U in the packed triangle, b's z entries in row n, the
// multipliers in L11[j][k] and the reciprocal pivots in rd.  Lane i holds
// row i of the block's lower triangle from the current column on: at step
// j, row[m] = S[c0 + i][c0 + j + m], so the entry each step needs is
// row[0] and the step's loop is one short body that runs w times.  Step
// j: the pivot is lane j's row[0] (one shuffle); each lane publishes
// row[0], which is S[i][j] = S[j][i], to column j of a U buffer (lane j
// b's z[j] too); after a __syncwarp the multiplier g_i = S[i][j] / D[j]
// takes g_i S[k][j] out of each S[i][k], k > j, read from the buffer as
// 16-byte broadcasts, as the row shifts down by one.
template <typename T>
__device__ inline void factor_diagonal(T* S, T* L11, T* rd, T* ucol, int n,
                                       int c0, int c1, int lane, bool& bad) {
  const int w = c1 - c0;
  T row[kPanel];
#pragma unroll
  for (int m = 0; m < kPanel; ++m)
    row[m] = (m <= lane && lane < w) ? S[row_off(c0 + lane) + c0 + m]
                                     : T(0);
  T* zrow = S + row_off(n) + c0;
  T z = lane < w ? zrow[lane] : T(0);
  T rp_own = T(0);
  for (int j = 0; j < w; ++j) {
    T* u = ucol + j * kUcol;  // u[m] = S[c0 + j + m][c0 + j]
    const T r0 = row[0];
    if (lane >= j) u[lane - j] = r0;
    if (lane == j) u[kPanel] = z;
    const T p = __shfl_sync(kFullMask, r0, j);
    __syncwarp();
    // uniform; p - p is 0 only for a finite p
    if (!(p > T(0)) || !(p - p == T(0))) bad = true;
    const T rp = recip(p);
    if (lane == j) rp_own = rp;
    const T g = lane > j ? r0 * rp : T(0);  // L[c0 + lane][c0 + j]
    L11[j * kPanel + lane] = g;
#pragma unroll
    for (int m4 = 0; m4 < kPanel; m4 += 4) {
      const Quad<T> v = load4(u + m4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m4 + e >= 1) row[m4 + e - 1] = row[m4 + e] - g * v.v[e];
    }
    row[kPanel - 1] = T(0);
    z -= g * u[kPanel];
  }
  __syncwarp();
  if (lane < w) {
    for (int j = 0; j < lane; ++j)
      S[row_off(c0 + lane) + c0 + j] = ucol[j * kUcol + lane - j];
    rd[c0 + lane] = rp_own;
    zrow[lane] = z;
  }
}

// All threads: the rows c1..n-1 below a full diagonal block at c0 solve
// U_r L11^T = S_r (a thread a row, the 32 columns in registers); U goes
// back to the triangle, L = U D^-1 to Lb[j][r - c1].  The columns of Lb
// that the tiles read past n - c1 are set to 0.
template <typename T>
__device__ inline void solve_rows(T* S, T* Lb, const T* L11, const T* rd,
                                  int ld, int n, int c0, int c1) {
  const int m = n - c1;
  for (int t = threadIdx.x; t < (m & ~3) + 4; t += kBlockThreads) {
    if (t >= m) {
#pragma unroll
      for (int j = 0; j < kPanel; ++j) Lb[j * ld + t] = T(0);
      continue;
    }
    T* row = S + row_off(c1 + t) + c0;
    T u[kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; j += 4) {
      const Quad<T> v = load4(row + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) u[j + e] = v.v[e];
    }
#pragma unroll
    for (int j = 0; j < kPanel - 1; ++j) {
#pragma unroll
      for (int k4 = (j + 1) & ~3; k4 < kPanel; k4 += 4) {
        const Quad<T> l = load4(L11 + j * kPanel + k4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k4 + e > j) u[k4 + e] -= u[j] * l.v[e];
      }
    }
#pragma unroll
    for (int j = 0; j < kPanel; j += 4) store4(row + j, u + j);
#pragma unroll
    for (int j = 0; j < kPanel; j += 4) {
      const Quad<T> r = load4(rd + c0 + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) Lb[(j + e) * ld + t] = u[j + e] * r.v[e];
    }
  }
}

// All threads: S[r][k] -= sum_j U[r][c0 + j] L[k][c0 + j] over the lower
// triangle of rows c1..n (b's row n included) and columns c1..n-1, in 4 x 4
// tiles.  Tile (a, b), b <= a, covers rows c1 + 4a.. and columns
// c1 + 4b..; a tile on the diagonal also updates padding above it (never
// read), and one past column n - 1 subtracts Lb's zeros.
template <typename T>
__device__ inline void update_trailing(T* S, const T* Lb, int ld, int n,
                                       int c0, int c1) {
  const int rows = (n - c1 + 4) >> 2;  // tile rows over c1..n
  const int tiles = rows * (rows + 1) / 2;
  int ta = 0, first = 0;  // tile t lies in tile row ta: first <= t <= first + ta
  for (int t = threadIdx.x; t < tiles; t += kBlockThreads) {
    while (t > first + ta) first += ++ta;
    const int tb = t - first;
    const int r0 = c1 + 4 * ta, k0 = 4 * tb;
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i <= n) {
        const Quad<T> v = load4(S + row_off(r0 + i) + c1 + k0);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = v.v[e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = T(0);
      }
    }
#pragma unroll 2
    for (int j = 0; j < kPanel; j += 4) {
      Quad<T> u[4];  // u[i].v[e] = U[r0 + i][c0 + j + e]
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = r0 + i <= n ? load4(S + row_off(r0 + i) + c0 + j)
                           : Quad<T>{{T(0), T(0), T(0), T(0)}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Quad<T> l = load4(Lb + (j + e) * ld + k0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] -= u[i].v[e] * l.v[q];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i <= n) store4(S + row_off(r0 + i) + c1 + k0, acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    chol_solve_block_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ x, int n, long long a_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // packed lower triangle, b row n
  const BlockLayout layout = block_layout(n);
  T* Lb = S + layout.lb;
  T* L11 = S + layout.l11;
  T* ucol = S + layout.ucol;
  T* rd = S + layout.rd;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const T* ga = a + blockIdx.x * a_stride;
  const T* gb = b + static_cast<long long>(blockIdx.x) * n;

  // The lower triangle, a warp per row: b and the first panel's rows by all
  // warps; then the rest by warps 1.. while warp 0 factors the first
  // diagonal block.
  for (int k = threadIdx.x; k < n; k += kBlockThreads)
    copy_async(S + row_off(n) + k, gb + k);
  const int first_rows = min(n, kPanel);
  for (int r = warp; r < first_rows; r += kBlockWarps)
    for (int k = lane; k <= r; k += kWarp)
      copy_async(S + row_off(r) + k, ga + static_cast<long long>(r) * n + k);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  if (warp != 0) {
    for (int r = first_rows + warp - 1; r < n; r += kBlockWarps - 1)
      for (int k = lane; k <= r; k += kWarp)
        copy_async(S + row_off(r) + k,
                   ga + static_cast<long long>(r) * n + k);
    copy_commit();
  }

  bool bad = false;  // warp 0's: every pivot passes through it
  for (int c0 = 0; c0 < n; c0 += kPanel) {
    const int c1 = min(c0 + kPanel, n);
    if (warp == 0)
      factor_diagonal(S, L11, rd, ucol, n, c0, c1, lane, bad);
    else if (c0 == 0)
      copy_wait<0>();
    __syncthreads();
    if (c1 == n) break;  // uniform: the last panel has no rows below
    solve_rows(S, Lb, L11, rd, layout.ld, n, c0, c1);
    __syncthreads();
    update_trailing(S, Lb, layout.ld, n, c0, c1);
    __syncthreads();
  }
  if (warp != 0) return;

  // Back substitution L^T x = D^-1 z by panels, the last first.  Lane k
  // takes z[c0 + k] and subtracts what the x of later panels (kept in row n
  // in place of z) bring through column c0 + k of U, j descending; then
  // for j = w-1 .. 0 one shuffle broadcasts x[c0 + j] and each lane k < j
  // does one FMA with U[c0 + j][c0 + k] (row j, consecutive addresses).
  T* zrow = S + row_off(n);
  T* gx = x + static_cast<long long>(blockIdx.x) * n;
  for (int c0 = (n - 1) & ~(kPanel - 1); c0 >= 0; c0 -= kPanel) {
    const int w = min(n - c0, kPanel);
    T zk = lane < w ? zrow[c0 + lane] : T(0);
    const T rk = lane < w ? rd[c0 + lane] : T(0);
#pragma unroll 4
    for (int j = n - 1; j >= c0 + kPanel; --j)  // full panels only
      zk -= S[row_off(j) + c0 + lane] * zrow[j];
    for (int j = w - 1; j >= 0; --j) {
      // lanes >= j read past row j's entries, into the triangle (unused)
      const T u = S[row_off(c0 + j) + c0 + lane];
      const T xj = __shfl_sync(kFullMask, zk * rk, j);
      const T zu = zk - u * xj;
      zk = lane < j ? zu : zk;
    }
    if (lane < w) {
      const T xk = zk * rk;
      zrow[c0 + lane] = xk;
      gx[c0 + lane] = bad ? T(NAN) : xk;
    }
    __syncwarp();
  }
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
int launch_block(const T* a, const T* b, T* x, int batch, int n,
                 long long a_stride, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_layout(n).total) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_block_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chol_solve_block_kernel<T><<<batch, kBlockThreads, smem, stream>>>(
      a, b, x, n, a_stride);
  return cudaGetLastError();
}

// The rule, fixed on (n, type):
//   n <= 32                 register kernel, one column per lane;
//   32 < n <= 64, float32   register kernel, two columns per lane
//                           (in float64 two columns are 256 registers a
//                           thread, more than the card has);
//   otherwise               block kernel.
constexpr int kRegMaxN32 = 2 * kWarp;
constexpr int kRegMaxN64 = kWarp;

int launch(const float* a, const float* b, float* x, int batch, int n,
           long long a_stride, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  if (n <= kWarp)
    return launch_reg<float, 1>(a, b, x, batch, n, a_stride, stream);
  if (n <= kRegMaxN32)
    return launch_reg<float, 2>(a, b, x, batch, n, a_stride, stream);
  return launch_block<float>(a, b, x, batch, n, a_stride, stream);
}

int launch(const double* a, const double* b, double* x, int batch, int n,
           long long a_stride, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  if (n <= kRegMaxN64)
    return launch_reg<double, 1>(a, b, x, batch, n, a_stride, stream);
  return launch_block<double>(a, b, x, batch, n, a_stride, stream);
}

}  // namespace

extern "C" {

// Largest n: the block kernel's back substitution holds 5 entries a lane
// (f64 n = 160 takes 150 KB of the card's 227 KB of shared memory).
int chol_solve_max_n() { return kMaxN; }

// Largest n of the register kernel in float32 (is_f64 = 0) or float64;
// every larger n up to chol_solve_max_n() takes the block kernel.
int chol_solve_register_max_n(int is_f64) {
  return is_f64 ? kRegMaxN64 : kRegMaxN32;
}

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
