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
// Block kernel, every larger n whose triangle fits one block's shared
// memory (float64 33 to 202, float32 65 to 303: dog's 79 and 85, the rat's
// 73, the float64 host paths' 38 to 73, soccer's 10v10 and 11v11 at 166 and
// 182, a HUMANOID 2v2 match at 254 in float32): one thread block of
// kBlockWarps = 4 warps per system, the matrix in shared memory.  Its bound on this card is the same byte bound (2.34 us at
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
//  48 KB); the largest n of each type is the largest whose layout fits the
//  227 KB a block may use (block_max_n), and nothing else bounds it.
//  Tensor cores: none.  In float32 they offer TF32 only, which cannot hold
//  the 2e-4 gate; in float64 the trailing update is at most 1.4 MFLOP a
//  system, a rank-32 SYRK whose time is small beside the pivot chain, so
//  DMMA would move nothing that sets the time.
//
// Global kernel, every larger n (float64 n > 202, float32 n > 303: a
// HUMANOID match of 2v2 in float64 at 254, larger HUMANOID and ANT
// matches up to 1,370 and beyond): one system on a thread-block cluster of
// kClusterCtas = 16 CTAs of 8 warps (fewer CTAs where the batch's clusters
// would not all be on the card at once), the same factor as the block
// kernel, with the packed triangle (b as row n) in a scratch tensor in
// device memory that the wrapper allocates (B x row_off(n + 1) elements; a
// 254 float64 system is ~260 KB, a 1,370 one ~7.5 MB, both within the
// card's 50 MB L2).  What bounds it on an H100: operations.  n^3 / 3 + 2 n^2
// of them at float64's 67 TFLOP/s on the tensor cores (DMMA) is 12.85 us
// at (1, 1,370) and 0.083 us at (1, 254); the bytes are less.  What stands
// between the kernel and that bound: the pivot chain (n steps of ~410
// cycles in float64, on one warp), the trailing update's n^3 / 6 FMAs with
// each tile read from and written back to L2 once a panel, and three
// cluster barriers a panel.  What each part of the design does:
//  (1) One system on a cluster, not on one SM.  Rank 0's warp 0 stages
//      each diagonal block and factors it (factor_diagonal, as in the block
//      kernel).  The other ranks rebuild the panel's multipliers from the
//      factored block in the triangle (panel_multipliers: the same
//      products; read through L2, which serves all ranks at once, where
//      reads of rank 0's shared memory queue at its SM).  The rows below
//      are dealt out in chunks of kRowChunk = 32 (chunk i to rank i % C),
//      staged by cp.async and solved there a thread a row (solve_row).  The
//      trailing triangle's 64 x 64 blocks are cut into runs of equal count,
//      column by column.  The z update of the back substitution is dealt
//      out over the cluster's warps in blocks of 32 entries, each panel's x
//      read from rank 0's shared memory (distributed shared memory).
//      Cluster barriers (release / acquire) separate the phases, and every
//      read of the triangle goes through L2 (cp.async.cg, ld.global.cg): a
//      tile written by one rank is read by another in a later phase.
//  (2) Float64's rank-32 update on the tensor cores: mma.sync m16n8k4 f64
//      (DMMA), a warp owning a 16 x 32 part of a block (4 tiles of 16 x 8,
//      its D fragments read from and written back to the triangle), A and
//      B read from the staged rows of the panel ([row][j], 36 apart: a
//      fragment load is one wavefront a half-warp), B scaled by -1 / D[j]
//      as it is loaded, so no transposed copy of L is made; 8 k-groups of
//      4, j ascending.  Float32 stays on FFMA (TF32 cannot hold the 2e-4
//      gate): a thread a 4 x 4 tile, L transposed once a column block (Lt),
//      each entry taking its 32 updates in the order j.
//  (3) Staging ahead: while a CTA updates one block, the next block's
//      panel rows are in flight (cp.async into the next of three buffers,
//      wait_group 1; each row's 32-entry segment is contiguous and starts
//      on 16 bytes) and, in float64, its D fragments are read; in the back
//      substitution, rank 0 stages the next panel's block of U while the
//      ranks update z.
//  (4) Lookahead: the first column block of the trailing update (which
//      holds the next panel's columns) goes first, over every rank; rank 0
//      then factors the next panel while ranks 1.. take the rest of the
//      update (a split cluster barrier, arrive then wait, lets rank 0 go on
//      as soon as that column is done).  The pivot chain is hidden where
//      the rest of the update takes longer than it.
//  Shared memory is fixed (219.5 KB a CTA in float64, 109.8 KB in float32)
//  whatever n.
//
// Pivots: a pivot that is not > 0 (or not finite) marks the system as not
// positive definite and its whole row of x is written as NaN, as
// jnp.linalg.cholesky gives; other systems are untouched.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see dm_control_torch/ops/_cuda_build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
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
// Shared memory one block may use on sm_90 (232,448 bytes, opted in above
// 48 KB): what bounds the block kernel's n.
constexpr size_t kSmemPerBlock = 227 * 1024;
// Largest n of all: row offsets are int (row_off(32769) < 2^31).
constexpr int kMaxN = 32768;

// Offset of row r in the packed lower triangle: row q takes q + 1 entries
// rounded up to 4, so rows 4u .. 4u + 3 take 4u + 4 each and
// sum_{q < 4u + v} = 8u(u + 1) + v(4u + 4).
__host__ __device__ constexpr int row_off(int r) {
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
// 16 bytes (4 float32 or 2 float64 entries) from device memory to shared
// memory; both addresses 16-byte aligned.
template <typename T>
__device__ inline void copy_async16(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
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

// One row below a full diagonal block solves U_r L11^T = S_r: its 32
// entries at `row` (16-byte aligned) are read into u, solved and written
// back as U.
template <typename T>
__device__ inline void solve_row(T* row, T (&u)[kPanel], const T* L11) {
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
    solve_row(row, u, L11);
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

// ---------------------------------------------------------------------------
// Global kernel: one system on a thread-block cluster, the triangle in a
// scratch tensor in device memory (every n above the block kernel's).

// CTAs of a cluster, one system: 16, the largest cluster an H100 runs
// (the portable largest is 8; 16 needs the non-portable opt-in and a GPC
// with 16 free SMs, which global_ctas asks the card for, taking fewer where
// it holds none).  Timed against 8 on an H100 (PERF.md): as fast at 203
// and 254, faster from 626 on, most at 1,370.
constexpr int kClusterCtas = 16;
constexpr int kGlobalWarps = 8;
constexpr int kGlobalThreads = kGlobalWarps * kWarp;
constexpr int kRowChunk = kWarp;  // rows below a panel dealt out at once
constexpr int kTile = 64;         // rows and columns of an update block
// A staged row: 32 entries, padded to 36, so that the four rows one DMMA
// fragment load reads start 32 bytes apart in the banks (float64).
constexpr int kChunkLd = kPanel + 4;
constexpr int kTileT = kTile + 4;  // a row of the transposed L (float32)

// Shared memory of one CTA, in elements, each part on 16 bytes: the
// diagonal block packed as in the triangle (rows 0..31, b's entries as row
// w), its L and U as in the block kernel, the panel's reciprocal pivots,
// the panel's x (rank 0) and a copy of it (every rank), the rows below being
// solved ([t][j], a thread a row), blocks of the panel's rows for L
// ([k - k_lo][j], three) and for U ([r - r_lo][j], three), and (float32) L
// transposed ([j][k - k_lo]).  219.5 KB in float64, 109.8 KB in float32.
constexpr int kGlobalD = 0;
constexpr int kGlobalL11 = kGlobalD + row_off(kPanel + 1);
constexpr int kGlobalUcol = kGlobalL11 + kPanel * kPanel;
constexpr int kGlobalRd = kGlobalUcol + kPanel * kUcol;
constexpr int kGlobalX = kGlobalRd + kPanel;
constexpr int kGlobalXl = kGlobalX + kPanel;
constexpr int kGlobalRows = kGlobalXl + kPanel;
constexpr int kGlobalLb = kGlobalRows + kGlobalThreads * kChunkLd;
constexpr int kGlobalUb = kGlobalLb + 3 * kTile * kChunkLd;
constexpr int kGlobalLt = kGlobalUb + 3 * kTile * kChunkLd;
constexpr int kGlobalTotal = kGlobalLt + kPanel * kTileT;

// The triangle is written by every CTA of the cluster and read by others
// after a cluster barrier: every read of it goes through L2 (cp.async.cg,
// ld.global.cg), never through an SM's own L1, whose lines may be stale.
__device__ inline Quad<float> load4_cg(const float* p) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}
__device__ inline void store4_cg(float* p, const float* v) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ inline void store4_cg(double* p, const double* v) {
  __stcg(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcg(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
}

// One warp: the diagonal block of columns c0..c0+w-1 (rows c0..c0+w-1 of
// the triangle G, packed as there) into D by 16-byte copies (row starts and
// c0 are multiples of 4 elements; a row's last copy ends in its padding);
// the caller commits.  stage_diagonal adds b's entries c0..c0+w-1 as row w
// and waits for them.
template <typename T>
__device__ inline void stage_block(T* D, const T* G, int c0, int w,
                                   int lane) {
  constexpr int kVec = 16 / sizeof(T);
  const int m = lane * kVec;
  for (int r = 0; r < w; ++r)
    if (m <= r)
      copy_async16(D + row_off(r) + m, G + row_off(c0 + r) + c0 + m);
}

template <typename T>
__device__ inline void stage_diagonal(T* D, const T* G, int n, int c0, int w,
                                      int lane) {
  constexpr int kVec = 16 / sizeof(T);
  stage_block(D, G, c0, w, lane);
  const int m = lane * kVec;
  if (m < w) copy_async16(D + row_off(w) + m, G + row_off(n) + c0 + m);
  copy_commit();
  copy_wait<0>();
  __syncwarp();
}

// All threads of a rank other than 0: the panel's multipliers and
// reciprocal pivots, rebuilt from the factored block in the triangle (U
// below the diagonal, 1 / D on it) as factor_diagonal made them,
// L11[j][i] = U[i][j] (1 / D[j]) for i > j: the same product of the same
// two numbers.  The block comes through L2, which serves every rank at
// once; from rank 0's shared memory (distributed shared memory) the ranks'
// reads queue at one SM.
template <typename T>
__device__ inline void panel_multipliers(T* D, T* L11, T* rd, const T* G,
                                         int c0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kPanel / kVec;
  for (int e = threadIdx.x; e < kPanel * kPerRow; e += kGlobalThreads) {
    const int r = e / kPerRow, m = (e % kPerRow) * kVec;
    if (m <= r)
      copy_async16(D + row_off(r) + m, G + row_off(c0 + r) + c0 + m);
  }
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < kPanel * kPanel; e += kGlobalThreads) {
    const int j = e / kPanel, i = e % kPanel;
    L11[e] = i > j ? D[row_off(i) + j] * D[row_off(j) + j] : T(0);
  }
  if (threadIdx.x < kPanel)
    rd[threadIdx.x] = D[row_off(threadIdx.x) + threadIdx.x];
  __syncthreads();
}

// All threads: rows lo..hi-1 of the panel at c0 (32 entries each; row n is
// b's) into buf[r - lo][j] by 16-byte copies; the caller commits and waits.
template <typename T>
__device__ inline void stage_rows(T* buf, const T* G, int c0, int lo,
                                  int hi) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kPanel / kVec;
  for (int e = threadIdx.x; e < (hi - lo) * kPerRow; e += kGlobalThreads) {
    const int k = e / kPerRow, m = (e % kPerRow) * kVec;
    copy_async16(buf + k * kChunkLd + m, G + row_off(lo + k) + c0 + m);
  }
}

// The rank's share of the rows c1..n-1 below a full diagonal block at c0:
// chunks of kRowChunk rows, chunk i to rank i % ranks.  A pass stages up to
// kGlobalWarps of the rank's chunks into R (a thread a row), solves
// U_r L11^T = S_r there (solve_row, as in the block kernel) and writes U
// back to the triangle.
template <typename T>
__device__ inline void solve_rank_rows(T* G, T* R, const T* L11, int n,
                                       int c0, int c1, int rank, int ranks) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kPanel / kVec;
  const int chunks = (n - c1 + kRowChunk - 1) / kRowChunk;
  const int t = threadIdx.x;
  for (int first = rank; first < chunks; first += kGlobalWarps * ranks) {
    for (int e = t; e < kGlobalThreads * kPerRow; e += kGlobalThreads) {
      const int s = e / kPerRow, m = (e % kPerRow) * kVec;
      const int chunk = first + (s / kRowChunk) * ranks;
      const int r = c1 + chunk * kRowChunk + s % kRowChunk;
      if (chunk < chunks && r < n)
        copy_async16(R + s * kChunkLd + m, G + row_off(r) + c0 + m);
    }
    copy_commit();
    copy_wait<0>();
    __syncthreads();
    const int chunk = first + (t / kRowChunk) * ranks;
    const int r = c1 + chunk * kRowChunk + t % kRowChunk;
    if (chunk < chunks && r < n) {
      T u[kPanel];
      solve_row(R + t * kChunkLd, u, L11);
#pragma unroll
      for (int j = 0; j < kPanel; j += 4)
        store4_cg(G + row_off(r) + c0 + j, u + j);
    }
    __syncthreads();
  }
}

// Float32: the staged rows of L's block (U, Lb[k][j]) scaled to
// L = U D^-1 and transposed into Lt[j][k], so that a tile's four columns
// are one 16-byte read and a warp's tiles read consecutive addresses, as
// the block kernel's Lb; the columns up to the next multiple of 4 past
// rows are 0; synchronises.
template <typename T>
__device__ inline void transpose_scale(T* Lt, const T* Lb, const T* rd,
                                       int rows) {
  for (int e = threadIdx.x; e < ((rows + 3) & ~3) * kPanel;
       e += kGlobalThreads) {
    const int k = e / kPanel, j = e % kPanel;
    Lt[j * kTileT + k] = k < rows ? Lb[k * kChunkLd + j] * rd[j] : T(0);
  }
  __syncthreads();
}

// Float32, all threads: S[r][k] -= sum_j U[r][c0 + j] L[k][c0 + j] for the
// rows r_lo..r_hi-1 (U staged in Uc) and the columns k_lo..k_hi-1 (L
// staged in Lt), k <= r, in 4 x 4 tiles read from and written back to the
// triangle G.  Both ranges start on multiples of 4; a warp's threads take
// two tile rows' tiles (U broadcast, L consecutive); each entry gets its
// 32 updates in the order j, as in update_trailing.
__device__ inline void update_tiles(float* G, const float* Uc,
                                    const float* Lt, int r_lo, int r_hi,
                                    int k_lo, int k_hi) {
  const int tile_rows = (r_hi - r_lo + 3) >> 2;
  const int tile_cols = (k_hi - k_lo + 3) >> 2;
  for (int t = threadIdx.x; t < tile_rows * tile_cols;
       t += kGlobalThreads) {
    const int ta = t / tile_cols, tb = t - ta * tile_cols;
    const int ru = 4 * ta, kc = 4 * tb;  // in the staged rows and columns
    if (k_lo + kc > r_lo + ru) continue;  // above the diagonal
    const int r0 = r_lo + ru;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < r_hi) {
        const Quad<float> v = load4_cg(G + row_off(r0 + i) + k_lo + kc);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = v.v[e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      }
    }
#pragma unroll 2
    for (int j = 0; j < kPanel; j += 4) {
      Quad<float> u[4];  // u[i].v[e] = U[r0 + i][c0 + j + e]
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = load4(Uc + (ru + i) * kChunkLd + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Quad<float> l = load4(Lt + (j + e) * kTileT + kc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] -= u[i].v[e] * l.v[q];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + i < r_hi) store4_cg(G + row_off(r0 + i) + k_lo + kc, acc[i]);
  }
}

// Float64 on the tensor cores (DMMA, m16n8k4, sm_90): D (16 x 8) +=
// A (16 x 4) B (4 x 8).  A thread holds a_h = A[g + 8 h][q], b = B[q][g]
// and d[2 h + e] = D[g + 8 h][2 q + e] (g = lane / 4, q = lane % 4).  On an
// H100 it gave the same bits as sm_80's m8n8k4 and sm_90's m16n8k8 and
// m16n8k16 (each entry takes its products in the order k), and the least
// time of the four (PERF.md: m8n8k4 against it).
__device__ inline void dmma(double& d0, double& d1, double& d2, double& d3,
                            double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// Float64: warp w's part of an update block, rows r_lo + 16 (w / 2) + 0..15
// and columns k_lo + 32 (w % 2) + 0..31, as 4 tiles of 16 x 8, each
// thread holding its D fragment of each: acc[h][ni][e] = D[g + 8 h][8 ni +
// 2 q + e] of the part.  An entry is read and written
// where it lies in the triangle's storage: row i < r_hi and column
// k <= (i | 3) (past i only the row's padding, never read as data); a
// thread's two columns 2q, 2q + 1 are one 16-byte access.
struct Part {
  double acc[2][4][2];
};

__device__ inline void load_part(Part& p, const double* G, int r_lo,
                                 int r_hi, int k_lo) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int i0 = r_lo + 16 * (warp >> 1) + (lane >> 2);
  const int k0 = k_lo + 32 * (warp & 1) + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int i = i0 + 8 * mi;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int k = k0 + 8 * ni;
      double2 v = make_double2(0.0, 0.0);
      if (i < r_hi && k <= (i | 3))
        v = __ldcg(reinterpret_cast<const double2*>(G + row_off(i) + k));
      p.acc[mi][ni][0] = v.x;
      p.acc[mi][ni][1] = v.y;
    }
  }
}

__device__ inline void store_part(const Part& p, double* G, int r_lo,
                                  int r_hi, int k_lo) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int i0 = r_lo + 16 * (warp >> 1) + (lane >> 2);
  const int k0 = k_lo + 32 * (warp & 1) + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int i = i0 + 8 * mi;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int k = k0 + 8 * ni;
      if (i < r_hi && k <= (i | 3))
        __stcg(reinterpret_cast<double2*>(G + row_off(i) + k),
               make_double2(p.acc[mi][ni][0], p.acc[mi][ni][1]));
    }
  }
}

// Float64: the rank-32 update of warp w's part, S[r][k] += U[r][j] B[j][k]
// with B[j][k] = -L[k][j] = U[k][j] (-1 / D[j]), both operands read from the
// staged rows ([row][j], the scale applied as B's fragment is loaded): 8
// k-groups of 4, j ascending, 4 DMMA each.  A part wholly above the
// diagonal (a diagonal block's upper right) is skipped.
__device__ inline void update_part(Part& p, const double* Ub,
                                   const double* Lb, const double* rd,
                                   int r_lo, int k_lo) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int wr = 16 * (warp >> 1), wc = 32 * (warp & 1);
  if (k_lo + wc > r_lo + wr + 15) return;  // warp-uniform
  const int g = lane >> 2, q = lane & 3;
  const double* ua = Ub + (wr + g) * kChunkLd + q;
  const double* lb = Lb + (wc + g) * kChunkLd + q;
#pragma unroll
  for (int j = 0; j < kPanel; j += 4) {
    const double nr = -rd[j + q];
    const double a0 = ua[j], a1 = ua[8 * kChunkLd + j];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      dmma(p.acc[0][ni][0], p.acc[0][ni][1], p.acc[1][ni][0], p.acc[1][ni][1],
           a0, a1, lb[8 * ni * kChunkLd + j] * nr);
  }
}

// Rank 0's warp 0: the diagonal block of the panel at c0 staged from the
// triangle and factored (factor_diagonal, as in the block kernel): L11 and
// the reciprocal pivots stay in its shared memory, U and b's z go back to
// the triangle, and 1 / D to the diagonal slot.
template <typename T>
__device__ inline void factor_panel(T* G, T* D, T* L11, T* rd, T* ucol,
                                    int n, int c0, int lane, bool& bad) {
  const int w = min(n - c0, kPanel);
  stage_diagonal(D, G, n, c0, w, lane);
  factor_diagonal(D, L11, rd, ucol, w, 0, w, lane, bad);
  if (lane < w) {  // its own row of D, written by this lane
    T* grow = G + row_off(c0 + lane) + c0;
    for (int j = 0; j < lane; ++j) grow[j] = D[row_off(lane) + j];
    grow[lane] = rd[lane];  // 1 / D in the diagonal slot
    G[row_off(n) + c0 + lane] = D[row_off(w) + lane];
  }
}

// The split cluster barrier: arrive (release) now, wait (acquire) later.
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// All threads: `count` blocks of the trailing update of the panel at c0
// (rows below it from c1), kTile rows (U; b's row n in the last) by kTile
// columns (L) of the lower triangle, taken column by column from block
// `first` of the columns from kb on, so that each column's rows are staged
// once.  The next block's rows are in flight (cp.async into the next of
// three buffers) and, in float64, its D fragments are read while the CTA
// updates one: one __syncthreads a block, and one at the end.
template <typename T>
__device__ inline void update_run(T* G, T* Lb, T* Ub, T* Lt, const T* rd,
                                  int n, int c0, int c1, int kb, int first,
                                  int count) {
  if (count <= 0) return;  // uniform
  const int row_blocks = (n + 1 - c1 + kTile - 1) / kTile;
  int rb = first;
  while (rb >= row_blocks - kb) {
    rb -= row_blocks - kb;
    ++kb;
  }
  rb += kb;
  stage_rows(Lb + (kb % 3) * kTile * kChunkLd, G, c0, c1 + kTile * kb,
             min(c1 + kTile * (kb + 1), n));
  stage_rows(Ub, G, c0, c1 + kTile * rb, min(c1 + kTile * (rb + 1), n + 1));
  copy_commit();
  int shown = -1;  // float32: the column block whose L stands in Lt
  Part part;       // float64: the block's D fragments
  if constexpr (sizeof(T) == 8)
    load_part(part, G, c1 + kTile * rb, min(c1 + kTile * (rb + 1), n + 1),
              c1 + kTile * kb);
  for (int t = 0, s = 0; t < count; ++t, s = s == 2 ? 0 : s + 1) {
    const int r_lo = c1 + kTile * rb, r_hi = min(r_lo + kTile, n + 1);
    const int k_lo = c1 + kTile * kb, k_hi = min(k_lo + kTile, n);
    const T* Ls = Lb + (kb % 3) * kTile * kChunkLd;
    const T* Us = Ub + s * kTile * kChunkLd;
    int kb2 = kb, rb2 = rb + 1;
    if (rb2 == row_blocks) rb2 = ++kb2;
    const int r2_lo = c1 + kTile * rb2, r2_hi = min(r2_lo + kTile, n + 1);
    Part next;
    if (t + 1 < count) {
      // The buffers that blocks t - 2 and before read: every warp is past
      // them (a column may hold a single block).
      if (kb2 != kb)
        stage_rows(Lb + (kb2 % 3) * kTile * kChunkLd, G, c0,
                   c1 + kTile * kb2, min(c1 + kTile * (kb2 + 1), n));
      stage_rows(Ub + (s == 2 ? 0 : s + 1) * kTile * kChunkLd, G, c0, r2_lo,
                 r2_hi);
      copy_commit();
      if constexpr (sizeof(T) == 8)  // block t + 1's, read meanwhile
        load_part(next, G, r2_lo, r2_hi, c1 + kTile * kb2);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if constexpr (sizeof(T) == 8) {
      update_part(part, Us, Ls, rd, r_lo, k_lo);
      store_part(part, G, r_lo, r_hi, k_lo);
      part = next;
    } else {
      if (kb != shown) {
        __syncthreads();  // every warp is done with the last column's Lt
        transpose_scale(Lt, Ls, rd, k_hi - k_lo);
        shown = kb;
      }
      update_tiles(G, Us, Lt, r_lo, r_hi, k_lo, k_hi);
    }
    kb = kb2;
    rb = rb2;
  }
  __syncthreads();  // the buffers are free for the next run
}

template <typename T>
__global__ void __launch_bounds__(kGlobalThreads, 1)
    chol_solve_global_kernel(const T* __restrict__ a,
                             const T* __restrict__ b, T* __restrict__ x,
                             T* scratch, int n, long long a_stride) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* D = smem + kGlobalD;
  T* L11 = smem + kGlobalL11;
  T* ucol = smem + kGlobalUcol;
  T* rdp = smem + kGlobalRd;
  T* xs = smem + kGlobalX;
  T* xl = smem + kGlobalXl;
  T* R = smem + kGlobalRows;
  T* Lb = smem + kGlobalLb;
  T* Ub = smem + kGlobalUb;
  T* Lt = smem + kGlobalLt;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int sys = blockIdx.x / ranks;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const T* ga = a + sys * a_stride;
  const T* gb = b + static_cast<long long>(sys) * n;
  // Read and written by the cluster alone: no __restrict__, no read-only
  // cache; cluster barriers order its CTAs' accesses.
  T* G = scratch + static_cast<long long>(sys) * row_off(n + 1);
  T* zrow = G + row_off(n);

  // The lower triangle and b into the scratch triangle, a warp a row, the
  // rows dealt out over the cluster's warps.
  if (rank == 0)
    for (int k = threadIdx.x; k < n; k += kGlobalThreads) zrow[k] = gb[k];
  for (int r = rank * kGlobalWarps + warp; r < n;
       r += ranks * kGlobalWarps) {
    const T* src = ga + static_cast<long long>(r) * n;
    T* dst = G + row_off(r);
    for (int k = lane; k <= r; k += kWarp) dst[k] = src[k];
  }
  cluster.sync();

  // Panel by panel, with lookahead: the trailing update's first column
  // block (which holds the next panel's columns) goes first, over every
  // rank; then rank 0's warp 0 factors the next panel while the other
  // ranks take the rest of the update.
  bool bad = false;  // rank 0's warp 0: every pivot passes through it
  if (rank == 0 && warp == 0)
    factor_panel(G, D, L11, rdp, ucol, n, 0, lane, bad);
  cluster.sync();
  for (int c0 = 0; c0 + kPanel < n; c0 += kPanel) {
    const int c1 = c0 + kPanel;  // a full panel, with rows below it
    if (rank != 0) panel_multipliers(D, L11, rdp, G, c0);
    solve_rank_rows(G, R, L11, n, c0, c1, rank, ranks);
    cluster.sync();
    const int row_blocks = (n + 1 - c1 + kTile - 1) / kTile;
    const int col_blocks = (n - c1 + kTile - 1) / kTile;
    const int blocks =
        col_blocks * row_blocks - col_blocks * (col_blocks - 1) / 2;
    // Run 0: column block 0 over every rank (in a cluster of one, every
    // block); run 1: the other columns over ranks 1...
    const bool ahead = ranks > 1;
    for (int run = 0; run < 2; ++run) {
      int kb = run, first = 0, count = 0;
      if (run == 0) {
        first = ahead ? rank * row_blocks / ranks : 0;
        count = ahead ? (rank + 1) * row_blocks / ranks - first : blocks;
      } else if (ahead && rank > 0) {
        const int rest = blocks - row_blocks;
        first = (rank - 1) * rest / (ranks - 1);
        count = rank * rest / (ranks - 1) - first;
      }
      update_run(G, Lb, Ub, Lt, rdp, n, c0, c1, kb, first, count);
      if (run == 0) {
        cluster_arrive();  // the next panel's columns are updated
        if (rank == 0) {
          cluster_wait();
          if (warp == 0)
            factor_panel(G, D, L11, rdp, ucol, n, c1, lane, bad);
        }
      }
    }
    if (rank != 0) cluster_wait();
    cluster.sync();  // the next panel is factored, this one's update done
  }

  // Back substitution L^T x = D^-1 z by panels, the last first.  Rank 0's
  // warp 0 holds the panel's block of U (1 / D on its diagonal), staged
  // while the panel before was solved, and reads z: lane k holds z[c0 + k],
  // whose later panels' terms are already out; for j = w-1 .. 0 one
  // shuffle broadcasts x[c0 + j] and each lane k < j does one FMA with
  // U[c0 + j][c0 + k].  Then every rank, with the panel's x read from rank
  // 0's shared memory: each z[k], k < c0, in blocks of 32 dealt out over the
  // cluster's warps, gives up U[j][k] x[j] for j = c0+w-1 .. c0 (row j,
  // consecutive addresses), U's entries read before the panel's x is.
  T* gx = x + static_cast<long long>(sys) * n;
  // U's block of a panel, by panel parity: D, or the factor's U buffer
  const auto block = [&](int p) { return p & 1 ? ucol : D; };
  const int last = (n - 1) / kPanel;
  if (rank == 0 && warp == 0) {
    stage_block(block(last), G, last * kPanel, n - last * kPanel, lane);
    copy_commit();
  }
  for (int p = last; p >= 0; --p) {
    const int c0 = p * kPanel, w = min(n - c0, kPanel);
    if (rank == 0 && warp == 0) {
      const T* U = block(p);
      copy_wait<0>();
      __syncwarp();
      if (p > 0) {  // the panel before's block lands meanwhile
        stage_block(block(p - 1), G, c0 - kPanel, kPanel, lane);
        copy_commit();
      }
      T zk = lane < w ? __ldcg(zrow + c0 + lane) : T(0);
      const T rk = lane < w ? U[row_off(lane) + lane] : T(0);
      for (int j = w - 1; j >= 0; --j) {
        // lanes >= j read past row j's entries, into the block (unused)
        const T u = U[row_off(j) + lane];
        const T xj = __shfl_sync(kFullMask, zk * rk, j);
        const T zu = zk - u * xj;
        zk = lane < j ? zu : zk;
      }
      if (lane < w) {
        const T xk = zk * rk;
        xs[lane] = xk;
        gx[c0 + lane] = bad ? T(NAN) : xk;
      }
    }
    if (p == 0) break;  // uniform: no z entry before the first panel
    // The warp's first block of z entries and its U entries, read now.
    const int kb0 = rank + ranks * warp;
    T uv[kPanel];
    T z0 = T(0);
    if (kb0 < p) {
#pragma unroll
      for (int j = 0; j < kPanel; ++j)
        uv[j] = j < w ? __ldcg(G + row_off(c0 + j) + kb0 * kPanel + lane)
                      : T(0);
      z0 = __ldcg(zrow + kb0 * kPanel + lane);
    }
    cluster.sync();
    if (threadIdx.x < w)
      xl[threadIdx.x] = cluster.map_shared_rank(xs, 0)[threadIdx.x];
    __syncthreads();
    if (kb0 < p) {
#pragma unroll
      for (int j = kPanel - 1; j >= 0; --j)
        if (j < w) z0 -= uv[j] * xl[j];
      __stcg(zrow + kb0 * kPanel + lane, z0);
    }
    for (int kb = kb0 + ranks * kGlobalWarps; kb < p;
         kb += ranks * kGlobalWarps) {
      const int k = kb * kPanel + lane;
      T zk = __ldcg(zrow + k);
#pragma unroll
      for (int j = kPanel - 1; j >= 0; --j)
        if (j < w) zk -= __ldcg(G + row_off(c0 + j) + k) * xl[j];
      __stcg(zrow + k, zk);
    }
    cluster.sync();  // z is whole, and no rank reads xs any more
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

// One cluster a system: a grid of batch x ctas CTAs launched with the
// cluster dimension.
template <typename T>
cudaLaunchConfig_t global_config(int batch, int ctas, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * ctas);
  config.blockDim = dim3(kGlobalThreads);
  config.dynamicSmemBytes = static_cast<size_t>(kGlobalTotal) * sizeof(T);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename T>
int global_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_global_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGlobalTotal * sizeof(T)));
  if (err == cudaSuccess && kClusterCtas > 8)
    err = cudaFuncSetAttribute(chol_solve_global_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

// Clusters of `ctas` CTAs (a power of two up to kClusterCtas) of the global
// kernel that the card holds at once, asked once a process and type.
template <typename T>
int global_clusters(int ctas, int* clusters) {
  static int held[5] = {-1, -1, -1, -1, -1};  // by log2(ctas)
  int& h = held[31 - __builtin_clz(ctas)];
  if (h < 0) {
    const int err = global_attributes<T>();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = global_config<T>(1, ctas, nullptr,
                                                       &attr);
    int count = 0;
    const cudaError_t asked = cudaOccupancyMaxActiveClusters(
        &count, chol_solve_global_kernel<T>, &config);
    if (asked != cudaSuccess) return asked;
    h = count;
  }
  *clusters = h;
  return cudaSuccess;
}

// CTAs a system at this batch: kClusterCtas, halved while the card cannot
// hold the batch's clusters at once (an H100 holds 7 clusters of 16), or
// one such cluster at all, down to 1: a batch that fills the card gains
// nothing from splitting a system, and pays for its barriers.  Each
// system's arithmetic is the same whatever the count.
template <typename T>
int global_ctas(int batch, int* ctas) {
  for (int c = kClusterCtas; c >= 1; c /= 2) {
    int clusters = 0;
    const int err = global_clusters<T>(c, &clusters);
    if (err != cudaSuccess) return err;
    if (clusters >= 1 && (batch <= clusters || c == 1)) {
      *ctas = c;
      return cudaSuccess;
    }
  }
  return cudaErrorLaunchOutOfResources;  // not one CTA fits an SM
}

// Refused (the wrapper says so) for a null scratch and where the card
// holds no cluster of the kernel.
template <typename T>
int launch_global(const T* a, const T* b, T* x, T* scratch, int batch, int n,
                  long long a_stride, cudaStream_t stream) {
  if (scratch == nullptr || batch > INT_MAX / kClusterCtas)
    return cudaErrorInvalidValue;
  int ctas = 0;
  int err = global_ctas<T>(batch, &ctas);
  if (err == cudaSuccess) err = global_attributes<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = global_config<T>(batch, ctas, stream,
                                                     &attr);
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, chol_solve_global_kernel<T>, a, b, x, scratch, n, a_stride);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

// The rule, fixed on (n, type):
//   n <= 32                 register kernel, one column per lane;
//   32 < n <= 64, float32   register kernel, two columns per lane
//                           (in float64 two columns are 256 registers a
//                           thread, more than the card has);
//   up to block_max_n<T>()  block kernel (float64 202, float32 303);
//   otherwise               global kernel, with the caller's scratch.
constexpr int kRegMaxN32 = 2 * kWarp;
constexpr int kRegMaxN64 = kWarp;

// The largest n whose block layout fits kSmemPerBlock.
template <typename T>
int block_max_n() {
  static const int max_n = [] {
    int n = 1;
    while (static_cast<size_t>(block_layout(n + 1).total) * sizeof(T) <=
           kSmemPerBlock)
      ++n;
    return n;
  }();
  return max_n;
}

int launch(const float* a, const float* b, float* x, float* scratch,
           int batch, int n, long long a_stride, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  if (n <= kWarp)
    return launch_reg<float, 1>(a, b, x, batch, n, a_stride, stream);
  if (n <= kRegMaxN32)
    return launch_reg<float, 2>(a, b, x, batch, n, a_stride, stream);
  if (n <= block_max_n<float>())
    return launch_block<float>(a, b, x, batch, n, a_stride, stream);
  return launch_global<float>(a, b, x, scratch, batch, n, a_stride, stream);
}

int launch(const double* a, const double* b, double* x, double* scratch,
           int batch, int n, long long a_stride, cudaStream_t stream) {
  if (batch == 0) return cudaSuccess;
  if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  if (n <= kRegMaxN64)
    return launch_reg<double, 1>(a, b, x, batch, n, a_stride, stream);
  if (n <= block_max_n<double>())
    return launch_block<double>(a, b, x, batch, n, a_stride, stream);
  return launch_global<double>(a, b, x, scratch, batch, n, a_stride, stream);
}

}  // namespace

extern "C" {

// Largest n of all: the triangle's row offsets are int.
int chol_solve_max_n() { return kMaxN; }

// Largest n of the register kernel in float32 (is_f64 = 0) or float64;
// every larger n up to chol_solve_block_max_n() takes the block kernel.
int chol_solve_register_max_n(int is_f64) {
  return is_f64 ? kRegMaxN64 : kRegMaxN32;
}

// Largest n of the block kernel in float32 (is_f64 = 0) or float64: the
// largest whose shared-memory layout fits a block; every larger n takes
// the global kernel.
int chol_solve_block_max_n(int is_f64) {
  return is_f64 ? block_max_n<double>() : block_max_n<float>();
}

// Elements of scratch a system of size n needs on the global kernel: the
// packed triangle with b as row n.
long long chol_solve_scratch_elems(int n) { return row_off(n + 1); }

// CTAs of the thread-block cluster that solves one system of float32
// (is_f64 = 0) or float64 on the global kernel at this batch on the current
// card (16 for a few systems on an H100, fewer for more), or -1 with the
// CUDA error in *err.
int chol_solve_cluster_ctas(int is_f64, int batch, int* err) {
  int ctas = 0;
  *err = is_f64 ? global_ctas<double>(batch, &ctas)
                : global_ctas<float>(batch, &ctas);
  return *err == cudaSuccess ? ctas : -1;
}

// Clusters of `ctas` CTAs of the global kernel in float32 or float64 that
// the current card holds at once (systems in flight), or -1 with the CUDA
// error in *err.
int chol_solve_global_active_clusters(int is_f64, int ctas, int* err) {
  if (ctas < 1 || ctas > kClusterCtas || (ctas & (ctas - 1))) {
    *err = cudaErrorInvalidValue;
    return -1;
  }
  int clusters = 0;
  *err = is_f64 ? global_clusters<double>(ctas, &clusters)
                : global_clusters<float>(ctas, &clusters);
  return *err == cudaSuccess ? clusters : -1;
}

// a_stride: elements between the matrices of consecutive systems, n * n
// for a (B, n, n) batch, 0 for one matrix shared by all systems.  scratch:
// batch * chol_solve_scratch_elems(n) elements of the type on the device
// where n takes the global kernel, else unused (may be null).
int chol_solve_f32(const float* a, const float* b, float* x, float* scratch,
                   int batch, int n, long long a_stride, void* stream) {
  return launch(a, b, x, scratch, batch, n, a_stride,
                static_cast<cudaStream_t>(stream));
}

int chol_solve_f64(const double* a, const double* b, double* x,
                   double* scratch, int batch, int n, long long a_stride,
                   void* stream) {
  return launch(a, b, x, scratch, batch, n, a_stride,
                static_cast<cudaStream_t>(stream));
}

const char* chol_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
