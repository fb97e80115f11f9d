// The fused scalar-chain physics step of a small model, as one kernel.
//
// Replaces no Pallas kernel: it stands in for XLA's fusion of the
// straight-line program that dm_control_tpu/physics/fastpath.py:190
// (build_step) traces, which the JAX package runs for pendulum, cartpole,
// acrobot, reacher, walker and cheetah.  The port's plain version is
// dm_control_torch/physics/fastpath.py (FastStep.plain); the plan this
// kernel reads is built there (FastStep._build_plan) and the layout names
// of both are checked against each other when the library is loaded
// (fastpath_layout_names), as is the shared-memory size of an environment
// (fastpath_env_bytes against fastpath.py's env_bytes).
//
// Design: a group of G lanes (a power of two up to 32, chosen on the host
// by fastpath.py's launch_layout: a warp for models with contact pairs,
// 8 or 16 lanes, at least nv, for the others) runs every step of one
// launch for one environment (the control step's substeps, or a reset's
// settle steps): FK, the smooth dynamics (com_pos, CRB with armature,
// com_vel, RNE, passive forces, actuation), the limit rows and the
// pyramidal contact rows (five colliders: plane-sphere, plane-capsule,
// sphere-sphere, sphere-capsule, capsule-capsule), the projected Newton
// solve with its exact line search, and Euler with implicit damping or
// RK4.  A block holds 128 / G environments (fewer where their shared
// memory would not fit), so the grid has B G / 128 blocks.  Each group
// runs its own Newton loop and stops when its environment is no longer
// live, which gives the JAX package's masked batch result; groups sync
// only among their own lanes (__syncwarp and shuffles on the group's
// mask), never across the block.  A control step is one launch.
//
// Work split, in a fixed order, so a run repeats bit for bit: FK and
// com_vel run a body a lane, each lane walking its body's chain from the
// root (every ancestor computed again as the serial pass computes it, so
// no sync between tree levels); per-body, per-dof and per-row work runs
// across the lanes, the contact pairs' geometry a pair a lane; the
// leaf-to-root sums run a component a lane, each in the serial order;
// each entry of M, of the gradient and of H = M + J' D J belongs to one
// lane, which sums its terms in row order.  The Newton solve reads only
// the rows that can carry force (D != 0: D is fixed over the solve, and a
// row with D = 0 adds exactly zero to every cost, gradient, Hessian and
// line-search sum), compacted once a forward by ballots; H and the
// gradient read those of them with jar < 0, compacted each iteration.
// The costs and the line search's sums are per-lane partial sums over
// strided rows, reduced by a fixed butterfly of shuffles (every lane
// holds the same bits, so the group's control flow stays uniform); the
// line search stops where a step leaves alpha unchanged, since each step
// is a function of alpha alone.  The nv x nv Cholesky factor runs a column
// at a time across the group in the plain version's order, and both
// substitutions run as chains of shuffles, multiplying by the pivots'
// reciprocals.
// The calls that sin, cos and pow may make (their slow paths) run in
// passes of their own, where few values are live.
//
// Memory: each environment's arrays (per body: frames, com, inertias,
// velocities, forces; per dof: anchors, axes, cdof, CRB times cdof; per
// row: J, aref, D, and the solver's jar and J p; M, H, the factor, the
// state and the solver's vectors, RK4's stages; the two lists of row
// indices) live in the block's dynamic shared memory, sized from the
// plan's counts (env_bytes).  The Newton solve and the Cholesky solves
// run in double for float32 too (see env_bytes).  Nothing of the step is indexed through a thread-local
// array.  The kernel allocates nothing and reads
// global memory only for the plan, the state and ctrl, and writes only
// the state.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 and float64): the
// function reads the state (qpos, qvel, warm, ctrl) and writes qpos,
// qvel, warm once: 4 nv + nu values in and 3 nv out an environment, a few
// hundred bytes; its operations are counted in chip_smoke.py from the
// code (per substep: FK and the smooth dynamics, the rows, and per Newton
// iteration the gradient, the Hessian, the factor and the line search).
// Both give bounds of microseconds at B = 8192; the kernel's cost is the
// latency of each environment's chain of dependent steps, which the lanes
// shorten and the many groups on each SM hide.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr double kMinVal = 1e-15;
constexpr double kMinImp = 0.0001;
constexpr double kMaxImp = 0.9999;
constexpr int kBlockThreads = 128;
constexpr int kMaxSharedBytes = 232448;  // a block's dynamic shared memory

// The plan's layout: counts, then the offset of each int array (into the
// int buffer), then the offset of each float array (into the float
// buffer).  The same names, in the same order, as COUNT_NAMES, INT_NAMES
// and FLOAT_NAMES of dm_control_torch/physics/fastpath.py.
enum Count {
  C_NBODY, C_NV, C_NU, C_NLIM, C_NPAIR, C_NROWS, C_INTEGRATOR, C_ITERATIONS,
  C_LS_ITERATIONS, C_HAS_DAMPING, N_COUNTS
};
enum IntArr {
  I_BODY_PARENT, I_BODY_JNTADR, I_BODY_JNTNUM, I_BODY_ROOT, I_BODY_QUAT_UNIT,
  I_BODY_IQUAT_UNIT, I_BODY_CHAIN, I_JNT_TYPE, I_JNT_QPOSADR, I_JNT_DOFADR,
  I_JNT_BODY, I_DOF_BODY, I_DOF_CHAIN, I_ACT_DOF, I_LIM_QPOSADR,
  I_LIM_DOFADR, I_PAIR_COLLIDER, I_PAIR_B1, I_PAIR_B2, I_PAIR_G1_UNIT,
  I_PAIR_G2_UNIT, I_PAIR_CONDIM, I_PAIR_ROW0, N_INT_ARR
};
enum FloatArr {
  F_OPT, F_BODY_POS, F_BODY_QUAT, F_BODY_IPOS, F_BODY_IQUAT, F_BODY_MASS,
  F_BODY_INERTIA, F_BODY_SUBTREEMASS, F_JNT_AXIS, F_JNT_POS, F_QPOS0,
  F_JNT_STIFFNESS, F_QPOS_SPRING, F_DOF_DAMPING, F_DOF_ARMATURE,
  F_DOF_DTDAMPING, F_ACT_GEAR, F_ACT_CTRLRANGE, F_ACT_FORCERANGE, F_LIM_SIGN,
  F_LIM_BOUND, F_LIM_MARGIN, F_LIM_INVWEIGHT, F_LIM_KBI, F_PAIR_G1_POS,
  F_PAIR_G1_MAT, F_PAIR_G1_SIZE, F_PAIR_G2_POS, F_PAIR_G2_MAT,
  F_PAIR_G2_SIZE, F_PAIR_FRICTION, F_PAIR_INCLUDEMARGIN, F_PAIR_INVWEIGHT,
  F_PAIR_INVPYR, F_PAIR_KBI, N_FLOAT_ARR
};
// F_OPT's entries
enum Opt { O_TIMESTEP, O_TOL_SCALE, O_GRAVITY };

const char kLayoutNames[] =
    "nbody,nv,nu,nlim,npair,nrows,integrator,iterations,ls_iterations,"
    "has_damping;"
    "body_parent,body_jntadr,body_jntnum,body_root,body_quat_unit,"
    "body_iquat_unit,body_chain,jnt_type,jnt_qposadr,jnt_dofadr,jnt_body,"
    "dof_body,dof_chain,act_dof,lim_qposadr,lim_dofadr,pair_collider,"
    "pair_b1,pair_b2,pair_g1_unit,pair_g2_unit,pair_condim,pair_row0;"
    "opt,body_pos,body_quat,body_ipos,body_iquat,body_mass,body_inertia,"
    "body_subtreemass,jnt_axis,jnt_pos,qpos0,jnt_stiffness,qpos_spring,"
    "dof_damping,dof_armature,dof_dtdamping,act_gear,act_ctrlrange,"
    "act_forcerange,lim_sign,lim_bound,lim_margin,lim_invweight,lim_kbi,"
    "pair_g1_pos,pair_g1_mat,pair_g1_size,pair_g2_pos,pair_g2_mat,"
    "pair_g2_size,pair_friction,pair_includemargin,pair_invweight,"
    "pair_invpyr,pair_kbi";

constexpr int kJointSlide = 2;
constexpr int kIntegratorEuler = 0;
enum Collider {
  PLANE_SPHERE, PLANE_CAPSULE, SPHERE_SPHERE, SPHERE_CAPSULE,
  CAPSULE_CAPSULE
};

// One environment's shared memory, in three parts.  Of the step's type
// T: per body kBodyW values, per dof kDofW, per row nv + 2 (J, then aref
// and D), M, and kVecs vectors of nv.  Of double, the solver's type: H
// and the factor L, kSolverVecs vectors of nv, and each row's jar and J p.
// Then two lists of row indices (the rows that can carry force, and those
// with force at the Newton iterate).  The same sizes as fastpath.py's
// env_bytes.
//
// Every Cholesky solve and the Newton solve run in double for both types:
// on a stiff contact float32's own Newton loop stops about the square
// root of its epsilon from the optimum (its costs, ~1e6, cannot see the
// soft directions), so a float32 step in float32 arithmetic lands
// wherever its roundings stop it; in double it lands where the float64
// step does.  The float64 kernel's arithmetic is the same either way.
constexpr int kBodyW = 60;
enum BodySlot {
  B_XPOS = 0, B_XQUAT = 3, B_XMAT = 7, B_XIPOS = 16, B_SCOM = 19,
  B_CINERT = 22, B_CRB = 32, B_CVEL = 42, B_CACC = 48, B_CFRC = 54
};
constexpr int kDofW = 18;
enum DofSlot { D_XANCHOR = 0, D_XAXIS = 3, D_CDOF = 6, D_F = 12 };
// the vectors of T: the state, a stage's inputs, the forward's outputs,
// the hinges' half-angle sines and cosines, then RK4's four stages of qvel
// and qacc
enum Vec {
  V_Q, V_V, V_W, V_QI, V_VI, V_QFS, V_QACC, V_SIN, V_COS, V_QVELS,
  V_QACCS = V_QVELS + 4, kVecs = V_QACCS + 4
};
// the solver's vectors, of double
enum SolverVec {
  S_QS, S_X, S_GRAD, S_NG, S_P, S_MP, S_XTRY, S_Y, S_RHS, S_QFC, kSolverVecs
};

__host__ __device__ __forceinline__ long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// values of T an environment
__host__ __device__ __forceinline__ int env_values(int nbody, int nv,
                                                   int nrows) {
  return nbody * kBodyW + nv * kDofW + nrows * (nv + 2) + nv * nv +
         kVecs * nv;
}

// values of double an environment
__host__ __device__ __forceinline__ int solver_values(int nv, int nrows) {
  return 2 * nv * nv + kSolverVecs * nv + 2 * nrows;
}

__host__ __device__ __forceinline__ long long env_bytes(int nbody, int nv,
                                                        int nrows,
                                                        int elem) {
  return align16((long long)env_values(nbody, nv, nrows) * elem) +
         align16((long long)solver_values(nv, nrows) * 8) +
         align16((long long)nrows * 8);
}

template <typename T>
struct Env {
  const int* ip;
  const T* fp;
  T* s;       // this environment's values of T in shared memory
  double* a;  // its values of double
  int* live;  // the rows that can carry force, D != 0 (nrows)
  int* act;   // of those, the rows with force at x, jar < 0 (nrows)
  int nbody, nv, nu, nlim, npair, nrows;
  int o_dof, o_row, o_mat, o_vec;
  // the group: this lane, its width, its first lane in the warp, the
  // group's lanes in the warp
  int l, G, base;
  unsigned mask;

  __device__ __forceinline__ int count(int c) const { return ip[c]; }
  __device__ __forceinline__ const int* I(int a) const {
    return ip + ip[N_COUNTS + a];
  }
  __device__ __forceinline__ const T* F(int a) const {
    return fp + ip[N_COUNTS + N_INT_ARR + a];
  }
  __device__ __forceinline__ T& body(int b, int slot) const {
    return s[b * kBodyW + slot];
  }
  __device__ __forceinline__ T& dof(int i, int slot) const {
    return s[o_dof + i * kDofW + slot];
  }
  // row r's J (k < nv), aref (k = nv) and D (k = nv + 1)
  __device__ __forceinline__ T& row(int r, int k) const {
    return s[o_row + r * (nv + 2) + k];
  }
  // M, nv x nv, row-major
  __device__ __forceinline__ T* M() const { return s + o_mat; }
  __device__ __forceinline__ T* vec(int v) const { return s + o_vec + v * nv; }
  // H and the factor L, nv x nv, row-major
  __device__ __forceinline__ double* H() const { return a; }
  __device__ __forceinline__ double* L() const { return a + nv * nv; }
  __device__ __forceinline__ double* svec(int v) const {
    return a + 2 * nv * nv + v * nv;
  }
  __device__ __forceinline__ double& jar(int r) const {
    return a[2 * nv * nv + kSolverVecs * nv + r];
  }
  __device__ __forceinline__ double& jp(int r) const {
    return a[2 * nv * nv + kSolverVecs * nv + nrows + r];
  }

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  template <typename V>
  __device__ __forceinline__ V bcast(V v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
  // the group's sum by a fixed butterfly: every lane gets the same bits
  template <typename V>
  __device__ __forceinline__ V sum(V v) const {
    for (int o = G >> 1; o > 0; o >>= 1)
      v = v + __shfl_xor_sync(mask, v, o, G);
    return v;
  }
  // the group's predicates, lane l at bit l
  __device__ __forceinline__ unsigned ballot(bool p) const {
    unsigned b = __ballot_sync(mask, p) >> base;
    return G == 32 ? b : b & ((1u << G) - 1u);
  }
};


// -- small vector algebra (the formulas of physics/mathx.py) ---------------

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  T o0 = a[1] * b[2] - a[2] * b[1];
  T o1 = a[2] * b[0] - a[0] * b[2];
  T o2 = a[0] * b[1] - a[1] * b[0];
  out[0] = o0; out[1] = o1; out[2] = o2;
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ void quat_mul(const T* u, const T* v, T* out) {
  T w = u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3];
  T x = u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2];
  T y = u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1];
  T z = u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0];
  out[0] = w; out[1] = x; out[2] = y; out[3] = z;
}

// vec + 2 (w c + u x c), c = u x vec
template <typename T>
__device__ __forceinline__ void rotate(const T* v, const T* q, T* out) {
  const T* u = q + 1;
  T c[3], uc[3];
  cross3(u, v, c);
  cross3(u, c, uc);
  for (int k = 0; k < 3; ++k) out[k] = v[k] + T(2) * (q[0] * c[k] + uc[k]);
}

template <typename T>
__device__ __forceinline__ void quat_to_mat(const T* q, T* m) {
  T w = q[0], x = q[1], y = q[2], z = q[3];
  T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  T wx = w * x, wy = w * y, wz = w * z;
  m[0] = T(1) - T(2) * (yy + zz); m[1] = T(2) * (xy - wz);
  m[2] = T(2) * (xz + wy);
  m[3] = T(2) * (xy + wz); m[4] = T(1) - T(2) * (xx + zz);
  m[5] = T(2) * (yz - wx);
  m[6] = T(2) * (xz - wy); m[7] = T(2) * (yz + wx);
  m[8] = T(1) - T(2) * (xx + yy);
}

template <typename T>
__device__ __forceinline__ void mat_vec(const T* m, const T* v, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = m[3 * i] * v[0] + m[3 * i + 1] * v[1] + m[3 * i + 2] * v[2];
}

template <typename T>
__device__ __forceinline__ void mat_mul(const T* a, const T* b, T* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] +
                       a[3 * i + 2] * b[6 + j];
}

// spatial inertia 10-vector [Ixx Iyy Izz Ixy Ixz Iyz, m c, m] of a body
// with mass, principal inertia, com offset c and principal axes imat
template <typename T>
__device__ __forceinline__ void inert_from_body(T mass, const T* inertia,
                                                const T* c, const T* imat,
                                                T* out) {
  T iw[9];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      iw[3 * i + k] = imat[3 * i] * inertia[0] * imat[3 * k] +
                      imat[3 * i + 1] * inertia[1] * imat[3 * k + 1] +
                      imat[3 * i + 2] * inertia[2] * imat[3 * k + 2];
  T c2 = dot3(c, c);
  out[0] = iw[0] + mass * (c2 - c[0] * c[0]);
  out[1] = iw[4] + mass * (c2 - c[1] * c[1]);
  out[2] = iw[8] + mass * (c2 - c[2] * c[2]);
  out[3] = iw[1] + mass * (T(0) - c[0] * c[1]);
  out[4] = iw[2] + mass * (T(0) - c[0] * c[2]);
  out[5] = iw[5] + mass * (T(0) - c[1] * c[2]);
  out[6] = mass * c[0]; out[7] = mass * c[1]; out[8] = mass * c[2];
  out[9] = mass;
}

// inertia times a motion vector: [I w + h x v, m v - h x w], h = m c
template <typename T>
__device__ __forceinline__ void inert_mul(const T* in, const T* vec,
                                          T* out) {
  const T* w = vec;
  const T* v = vec + 3;
  const T* h = in + 6;
  T hv[3], hw[3];
  cross3(h, v, hv);
  cross3(h, w, hw);
  T iw0 = in[0] * w[0] + in[3] * w[1] + in[4] * w[2];
  T iw1 = in[3] * w[0] + in[1] * w[1] + in[5] * w[2];
  T iw2 = in[4] * w[0] + in[5] * w[1] + in[2] * w[2];
  out[0] = iw0 + hv[0]; out[1] = iw1 + hv[1]; out[2] = iw2 + hv[2];
  for (int k = 0; k < 3; ++k) out[3 + k] = in[9] * v[k] - hw[k];
}

template <typename T>
__device__ __forceinline__ void motion_cross(const T* v, const T* m,
                                             T* out) {
  T a[3], b[3], c[3];
  cross3(v, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m, c);
  for (int k = 0; k < 3; ++k) {
    out[k] = a[k];
    out[3 + k] = b[k] + c[k];
  }
}

template <typename T>
__device__ __forceinline__ void force_cross(const T* v, const T* f, T* out) {
  T a[3], b[3], c[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f + 3, c);
  for (int k = 0; k < 3; ++k) {
    out[k] = a[k] + b[k];
    out[3 + k] = c[k];
  }
}

template <typename T>
__device__ __forceinline__ T dot6(const T* a, const T* b) {
  T s = a[0] * b[0];
  for (int k = 1; k < 6; ++k) s = s + a[k] * b[k];
  return s;
}

template <typename T>
__device__ __forceinline__ T norm3(const T* v) {
  return sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// max, min and clamp that keep a NaN, as jnp.maximum and torch.clamp do
// (fmax and fmin would drop it): a diverged environment stays NaN
template <typename T>
__device__ __forceinline__ T maxn(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T>
__device__ __forceinline__ T minn(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
  return minn(maxn(x, lo), hi);
}

// -- the group's Cholesky solve ---------------------------------------------

// x = A^-1 b for an SPD n x n matrix A (row-major, lower triangle read),
// n <= G, in double: the factor L a column at a time, lane i its row i,
// each entry subtracting its products in the order of the plain version
// (_chol_solve), the pivot sqrt(max(s, 1e-15)) from lane 0, which also
// keeps its reciprocal; then both substitutions as chains of shuffles,
// lane i holding row i's running sum and each step multiplying by the
// pivot's reciprocal (the backward one subtracts from the last row up,
// the plain version from the first row down: the same sums, other
// roundings).  x aliases neither A nor b.  Ends synced.
template <typename T>
__device__ __forceinline__ void chol_solve(const Env<T>& e, const double* A,
                                           const double* b, double* x) {
  const int n = e.nv, l = e.l;
  double* L = e.L();
  double* inv = e.svec(S_Y);
  for (int j = 0; j < n; ++j) {
    const int i = j + l;
    double s = 0.0;
    if (i < n) {
      s = A[i * n + j];
      for (int k = 0; k < j; ++k) s = s - L[i * n + k] * L[j * n + k];
    }
    double d = e.bcast(sqrt(maxn(s, kMinVal)), 0);
    if (i < n) L[i * n + j] = l == 0 ? d : s / d;
    if (l == 0) inv[j] = 1.0 / d;
    e.sync();
  }
  double s = l < n ? b[l] : 0.0, y = 0.0;
  for (int k = 0; k < n; ++k) {
    const double yk = e.bcast(s * inv[k], k);
    if (l == k) y = yk;
    if (l > k && l < n) s = s - L[l * n + k] * yk;
  }
  for (int k = n - 1; k >= 0; --k) {
    const double xk = e.bcast(y * inv[k], k);
    if (l == k) x[k] = xk;
    if (l < k) y = y - L[k * n + l] * xk;
  }
  e.sync();
}

// -- kinematics -------------------------------------------------------------

// b's ancestor d levels up (d = 0: b itself)
__device__ __forceinline__ int ancestor(const int* parent, int b, int d) {
  for (; d > 0; --d) b = parent[b];
  return b;
}

__device__ __forceinline__ int depth_of(const int* parent, int b) {
  int d = 0;
  for (; b != 0; b = parent[b]) ++d;
  return d;
}

// FK of body b, walked from the root down its chain: each ancestor's frame
// is computed again as the serial pass over the bodies computes it (the
// same operations in the same order, so the same bits), so the bodies
// need no sync between tree levels.  Writes b's frame and its own joints'
// anchors and axes.  The hinges' half-angle sines and cosines come from
// V_SIN and V_COS.  Then b's xmat, xipos and m xipos.
template <typename T>
__device__ __forceinline__ void fk_body(const Env<T>& e, const T* q, int b) {
  const int* parent = e.I(I_BODY_PARENT);
  const int* jadr = e.I(I_BODY_JNTADR);
  const int* jnum = e.I(I_BODY_JNTNUM);
  const int* qunit = e.I(I_BODY_QUAT_UNIT);
  const int* jtype = e.I(I_JNT_TYPE);
  const int* qadr = e.I(I_JNT_QPOSADR);
  const T* bpos = e.F(F_BODY_POS);
  const T* bquat = e.F(F_BODY_QUAT);
  const T* jaxis = e.F(F_JNT_AXIS);
  const T* jpos = e.F(F_JNT_POS);
  const T* qpos0 = e.F(F_QPOS0);
  const T* sn = e.vec(V_SIN);
  const T* cs = e.vec(V_COS);
  T pos[3] = {T(0), T(0), T(0)}, quat[4] = {T(1), T(0), T(0), T(0)};
  for (int d = depth_of(parent, b) - 1; d >= 0; --d) {
    const int c = ancestor(parent, b, d);
    const bool own = d == 0;
    T pq[4], r[3];
    for (int k = 0; k < 4; ++k) pq[k] = quat[k];
    rotate(bpos + 3 * c, pq, r);
    for (int k = 0; k < 3; ++k) pos[k] = pos[k] + r[k];
    if (!qunit[c]) quat_mul(pq, bquat + 4 * c, quat);
    for (int j = jadr[c]; j < jadr[c] + jnum[c]; ++j) {
      const T* ja = jaxis + 3 * j;
      const T* jp = jpos + 3 * j;
      if (jtype[j] == kJointSlide) {
        T axis_w[3], rp[3];
        rotate(ja, quat, axis_w);
        const int a = qadr[j];
        T dq = q[a] - qpos0[a];
        for (int k = 0; k < 3; ++k) pos[k] = pos[k] + axis_w[k] * dq;
        if (own) {
          rotate(jp, quat, rp);
          for (int k = 0; k < 3; ++k) {
            e.dof(j, D_XANCHOR + k) = pos[k] + rp[k];
            e.dof(j, D_XAXIS + k) = axis_w[k];
          }
        }
      } else {  // hinge
        T rp[3], anchor[3], aq[4], nq[4];
        rotate(jp, quat, rp);
        for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + rp[k];
        aq[0] = cs[j];
        for (int k = 0; k < 3; ++k) aq[1 + k] = ja[k] * sn[j];
        quat_mul(quat, aq, nq);
        for (int k = 0; k < 4; ++k) quat[k] = nq[k];
        rotate(jp, quat, rp);
        for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - rp[k];
        if (own) {
          T ax[3];
          rotate(ja, quat, ax);
          for (int k = 0; k < 3; ++k) {
            e.dof(j, D_XANCHOR + k) = anchor[k];
            e.dof(j, D_XAXIS + k) = ax[k];
          }
        }
      }
    }
  }
  for (int k = 0; k < 3; ++k) e.body(b, B_XPOS + k) = pos[k];
  for (int k = 0; k < 4; ++k) e.body(b, B_XQUAT + k) = quat[k];
  // xmat, xipos and m xipos
  T xm[9], r[3];
  quat_to_mat(quat, xm);
  for (int k = 0; k < 9; ++k) e.body(b, B_XMAT + k) = xm[k];
  mat_vec(xm, e.F(F_BODY_IPOS) + 3 * b, r);
  for (int k = 0; k < 3; ++k) {
    T xi = pos[k] + r[k];
    e.body(b, B_XIPOS + k) = xi;
    e.body(b, B_SCOM + k) = e.F(F_BODY_MASS)[b] * xi;
  }
}

// com_vel and RNE's forward pass for body b, walked from the root down its
// chain as fk_body walks it: writes b's cvel and cacc
template <typename T>
__device__ __forceinline__ void vel_body(const Env<T>& e, const T* v, int b) {
  const int* parent = e.I(I_BODY_PARENT);
  const int* jadr = e.I(I_BODY_JNTADR);
  const int* jnum = e.I(I_BODY_JNTNUM);
  const int* jdof = e.I(I_JNT_DOFADR);
  const T* grav = e.F(F_OPT) + O_GRAVITY;
  T vel[6], a[6];
  for (int k = 0; k < 3; ++k) {
    vel[k] = T(0);
    vel[3 + k] = T(0);
    a[k] = T(0);
    a[3 + k] = -grav[k];
  }
  for (int d = depth_of(parent, b) - 1; d >= 0; --d) {
    const int c = ancestor(parent, b, d);
    for (int j = jadr[c]; j < jadr[c] + jnum[c]; ++j) {
      const int dd = jdof[j];
      T cd[6], cdd[6];
      for (int k = 0; k < 6; ++k) cd[k] = e.dof(dd, D_CDOF + k);
      motion_cross(vel, cd, cdd);
      for (int k = 0; k < 6; ++k) {
        vel[k] = vel[k] + cd[k] * v[dd];
        a[k] = a[k] + cdd[k] * v[dd];
      }
    }
  }
  for (int k = 0; k < 6; ++k) {
    e.body(b, B_CVEL + k) = vel[k];
    e.body(b, B_CACC + k) = a[k];
  }
}

// FK, com_pos, CRB, com_vel, RNE, passive and actuation: M and
// qfrc_smooth; the body and dof arrays stay in shared memory.  Ends synced.
template <typename T>
__device__ __forceinline__ void smooth(const Env<T>& e, const T* q,
                                       const T* v, const T* ctrl, T* M,
                                       T* qfs) {
  const int nb = e.nbody, nv = e.nv, l = e.l, G = e.G;
  const int* parent = e.I(I_BODY_PARENT);
  const int* root = e.I(I_BODY_ROOT);
  const int* iunit = e.I(I_BODY_IQUAT_UNIT);
  const int* jtype = e.I(I_JNT_TYPE);
  const int* jdof = e.I(I_JNT_DOFADR);
  const int* jbody = e.I(I_JNT_BODY);
  const int* dbody = e.I(I_DOF_BODY);
  const int* dchain = e.I(I_DOF_CHAIN);
  const T* iquat = e.F(F_BODY_IQUAT);
  const T* mass = e.F(F_BODY_MASS);
  const T* inertia = e.F(F_BODY_INERTIA);
  const T* stm = e.F(F_BODY_SUBTREEMASS);
  // the hinges' half-angle sines and cosines, a joint a lane (apart from
  // FK, so the calls their slow paths make run with few values live)
  {
    const int* qadr = e.I(I_JNT_QPOSADR);
    const T* qpos0 = e.F(F_QPOS0);
    for (int j = l; j < nv; j += G) {
      if (jtype[j] == kJointSlide) continue;
      T half = (q[qadr[j]] - qpos0[qadr[j]]) * T(0.5);
      e.vec(V_SIN)[j] = sin(half);
      e.vec(V_COS)[j] = cos(half);
    }
  }
  e.sync();
  for (int b = l; b < nb; b += G) fk_body(e, q, b);
  e.sync();
  // com_pos: m xipos summed from the leaves, a component a lane
  for (int k = l; k < 3; k += G) {
    for (int b = nb - 1; b >= 1; --b)
      e.body(parent[b], B_SCOM + k) =
          e.body(parent[b], B_SCOM + k) + e.body(b, B_SCOM + k);
    for (int b = 0; b < nb; ++b)
      e.body(b, B_SCOM + k) = e.body(b, B_SCOM + k) / stm[b];
  }
  e.sync();
  // cinert about the root's com (crb starts as cinert), a body a lane;
  // cdof, a joint a lane (nv == njnt)
  for (int b = l; b < nb; b += G) {
    T xm[9], im[9], off[3], ci[10];
    for (int k = 0; k < 9; ++k) xm[k] = e.body(b, B_XMAT + k);
    if (iunit[b]) {
      for (int k = 0; k < 9; ++k) im[k] = xm[k];
    } else {
      T iq[9];
      quat_to_mat(iquat + 4 * b, iq);
      mat_mul(xm, iq, im);
    }
    for (int k = 0; k < 3; ++k)
      off[k] = e.body(b, B_XIPOS + k) - e.body(root[b], B_SCOM + k);
    inert_from_body(mass[b], inertia + 3 * b, off, im, ci);
    for (int k = 0; k < 10; ++k) {
      e.body(b, B_CINERT + k) = ci[k];
      e.body(b, B_CRB + k) = ci[k];
    }
  }
  for (int j = l; j < nv; j += G) {
    int d = jdof[j];
    T ax[3];
    for (int k = 0; k < 3; ++k) ax[k] = e.dof(j, D_XAXIS + k);
    if (jtype[j] == kJointSlide) {
      for (int k = 0; k < 3; ++k) {
        e.dof(d, D_CDOF + k) = T(0);
        e.dof(d, D_CDOF + 3 + k) = ax[k];
      }
    } else {
      int r = root[jbody[j]];
      T arm[3], c[3];
      for (int k = 0; k < 3; ++k)
        arm[k] = e.body(r, B_SCOM + k) - e.dof(j, D_XANCHOR + k);
      cross3(ax, arm, c);
      for (int k = 0; k < 3; ++k) {
        e.dof(d, D_CDOF + k) = ax[k];
        e.dof(d, D_CDOF + 3 + k) = c[k];
      }
    }
  }
  e.sync();
  // CRB: composite inertias from the leaves, a component a lane; com_vel
  // and RNE's forward pass, a body a lane (each walks its chain)
  for (int k = l; k < 10; k += G)
    for (int b = nb - 1; b >= 1; --b)
      e.body(parent[b], B_CRB + k) =
          e.body(parent[b], B_CRB + k) + e.body(b, B_CRB + k);
  for (int b = l; b < nb; b += G) vel_body(e, v, b);
  e.sync();
  // f_i = crb cdof_i, a dof a lane
  for (int i = l; i < nv; i += G) {
    T crb[10], cd[6], f[6];
    for (int k = 0; k < 10; ++k) crb[k] = e.body(dbody[i], B_CRB + k);
    for (int k = 0; k < 6; ++k) cd[k] = e.dof(i, D_CDOF + k);
    inert_mul(crb, cd, f);
    for (int k = 0; k < 6; ++k) e.dof(i, D_F + k) = f[k];
  }
  e.sync();

  // M over each dof's chain, an entry (i, j <= i) a lane; cfrc, a body a
  // lane
  {
    const T* armature = e.F(F_DOF_ARMATURE);
    for (int t = l; t < nv * (nv + 1) / 2; t += G) {
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= t) ++i;
      const int j = t - i * (i + 1) / 2;
      T mij = T(0);
      if ((dchain[i] >> j) & 1) {
        T f[6], cj[6];
        for (int k = 0; k < 6; ++k) {
          f[k] = e.dof(i, D_F + k);
          cj[k] = e.dof(j, D_CDOF + k);
        }
        mij = dot6(f, cj);
      }
      if (i == j) mij = mij + armature[i];
      M[i * nv + j] = mij;
      M[j * nv + i] = mij;
    }
  }
  for (int b = l; b < nb; b += G) {
    T ci[10], a[6], vel[6], f1[6], iv[6], f2[6];
    for (int k = 0; k < 10; ++k) ci[k] = e.body(b, B_CINERT + k);
    for (int k = 0; k < 6; ++k) {
      a[k] = e.body(b, B_CACC + k);
      vel[k] = e.body(b, B_CVEL + k);
    }
    inert_mul(ci, a, f1);
    inert_mul(ci, vel, iv);
    force_cross(vel, iv, f2);
    for (int k = 0; k < 6; ++k) e.body(b, B_CFRC + k) = f1[k] + f2[k];
  }
  e.sync();
  // cfrc summed from the leaves, a component a lane
  for (int k = l; k < 6; k += G)
    for (int b = nb - 1; b >= 1; --b)
      e.body(parent[b], B_CFRC + k) =
          e.body(parent[b], B_CFRC + k) + e.body(b, B_CFRC + k);
  e.sync();

  // passive, actuation; qfrc_smooth = passive - bias + actuation, a dof
  // a lane
  const T* damping = e.F(F_DOF_DAMPING);
  const T* stiffness = e.F(F_JNT_STIFFNESS);
  const T* spring = e.F(F_QPOS_SPRING);
  const int* qadr = e.I(I_JNT_QPOSADR);
  const int* adof = e.I(I_ACT_DOF);
  const T* gear = e.F(F_ACT_GEAR);
  const T* crange = e.F(F_ACT_CTRLRANGE);
  const T* frange = e.F(F_ACT_FORCERANGE);
  for (int i = l; i < nv; i += G) {
    T passive = (-damping[i]) * v[i];
    for (int j = 0; j < nv; ++j)
      if (jdof[j] == i && stiffness[j] != T(0))
        passive = passive - stiffness[j] * (q[qadr[j]] - spring[qadr[j]]);
    T act = T(0);
    for (int u = 0; u < e.nu; ++u) {
      if (adof[u] != i) continue;
      T c = clampv(ctrl[u], crange[2 * u], crange[2 * u + 1]);
      act = act + clampv(gear[u] * c, frange[2 * u], frange[2 * u + 1]);
    }
    T cd[6], cf[6];
    for (int k = 0; k < 6; ++k) {
      cd[k] = e.dof(i, D_CDOF + k);
      cf[k] = e.body(dbody[i], B_CFRC + k);
    }
    qfs[i] = passive - dot6(cd, cf) + act;
  }
  e.sync();
}

// -- constraint rows --------------------------------------------------------

// constraints.kbi from a row's statics (see fastpath.py::_kbi_static)
template <typename T>
__device__ __forceinline__ void kbi(const T* st, T pos, T* k, T* b,
                                    T* imp) {
  T dmin = st[0], dspan = st[1], width = st[2], mid = st[3], power = st[4];
  T x = clampv(fabs(pos) / width, T(0), T(1));
  T y;
  if (x < mid)
    y = pow(x / mid, power) * mid;
  else
    y = T(1) - pow((T(1) - x) / (T(1) - mid), power) * (T(1) - mid);
  T im = clampv(dmin + y * dspan, T(kMinImp), T(kMaxImp));
  *imp = im;
  *k = st[5] > T(0) ? st[6] * im : im / st[6];
  *b = st[7];
}

template <typename T>
__device__ __forceinline__ void make_frame(const T* n, T* frame) {
  T a[3] = {T(0), T(0), T(0)};
  if (fabs(n[1]) < T(0.5)) a[1] = T(1); else a[2] = T(1);
  T na = dot3(n, a);
  T t1[3];
  for (int k = 0; k < 3; ++k) t1[k] = a[k] - n[k] * na;
  T ln = maxn(norm3(t1), T(kMinVal));
  for (int k = 0; k < 3; ++k) t1[k] = t1[k] / ln;
  for (int k = 0; k < 3; ++k) {
    frame[k] = n[k];
    frame[3 + k] = t1[k];
  }
  cross3(n, t1, frame + 6);
}

template <typename T>
__device__ __forceinline__ void sphere_pair(const T* c1, T r1, const T* c2,
                                            T r2, T* dist, T* pos,
                                            T* frame) {
  T diff[3], n[3];
  for (int k = 0; k < 3; ++k) diff[k] = c2[k] - c1[k];
  T ln = norm3(diff);
  T lc = maxn(ln, T(kMinVal));
  for (int k = 0; k < 3; ++k) n[k] = diff[k] / lc;
  T d = ln - (r1 + r2);
  *dist = d;
  for (int k = 0; k < 3; ++k) pos[k] = c1[k] + n[k] * (r1 + T(0.5) * d);
  make_frame(n, frame);
}

template <typename T>
__device__ __forceinline__ void closest_on_seg(const T* p, const T* a,
                                               const T* b, T* out) {
  T ab[3], pa[3];
  for (int k = 0; k < 3; ++k) {
    ab[k] = b[k] - a[k];
    pa[k] = p[k] - a[k];
  }
  T t = dot3(pa, ab) / maxn(dot3(ab, ab), T(kMinVal));
  t = clampv(t, T(0), T(1));
  for (int k = 0; k < 3; ++k) out[k] = a[k] + t * ab[k];
}

// the contacts a pair of a collider makes
__device__ __forceinline__ int contacts_of(int kind) {
  return kind == PLANE_CAPSULE ? 2 : 1;
}

// contact `which` of the colliders of physics/collision.py for geom 1 at
// p1 with z axis z1 (its frame's third column, the only one they read)
// and size s1, and geom 2 at (p2, z2) of size s2: its distance, point and
// frame (a pair's contacts one at a time, each computed as the collider
// computes it)
template <typename T>
__device__ __forceinline__ void collide(int kind, int which, const T* p1,
                                        const T* z1, const T* s1,
                                        const T* p2, const T* z2,
                                        const T* s2, T* dist, T* pos,
                                        T* frame) {
  if (kind == PLANE_SPHERE) {
    T r = s2[0], d[3];
    for (int k = 0; k < 3; ++k) d[k] = p2[k] - p1[k];
    T dd = dot3(z1, d) - r;
    dist[0] = dd;
    for (int k = 0; k < 3; ++k) pos[k] = p2[k] - z1[k] * (r + T(0.5) * dd);
    make_frame(z1, frame);
    return;
  }
  if (kind == PLANE_CAPSULE) {
    T r = s2[0], hl = s2[1];
    T na = dot3(z1, z2);
    T t1[3];
    for (int k = 0; k < 3; ++k) t1[k] = z2[k] - z1[k] * na;
    T t1n = norm3(t1);
    T fr[9];
    make_frame(z1, fr);
    if (t1n < T(1e-10)) {
      for (int k = 0; k < 3; ++k) t1[k] = fr[3 + k];
    } else {
      T c = maxn(t1n, T(kMinVal));
      for (int k = 0; k < 3; ++k) t1[k] = t1[k] / c;
    }
    for (int k = 0; k < 3; ++k) {
      fr[k] = z1[k];
      fr[3 + k] = t1[k];
    }
    cross3(z1, t1, fr + 6);
    T np1 = dot3(z1, p1);
    T cap[3];
    for (int k = 0; k < 3; ++k) {
      T hla = hl * z2[k];
      cap[k] = which == 0 ? p2[k] + hla : p2[k] - hla;
    }
    T dd = dot3(cap, z1) - np1 - r;
    dist[0] = dd;
    for (int k = 0; k < 3; ++k) pos[k] = cap[k] - z1[k] * (r + T(0.5) * dd);
    for (int k = 0; k < 9; ++k) frame[k] = fr[k];
    return;
  }
  if (kind == SPHERE_SPHERE) {
    sphere_pair(p1, s1[0], p2, s2[0], dist, pos, frame);
    return;
  }
  if (kind == SPHERE_CAPSULE) {
    T a[3], b[3], cl[3];
    for (int k = 0; k < 3; ++k) {
      T half = s2[1] * z2[k];
      a[k] = p2[k] - half;
      b[k] = p2[k] + half;
    }
    closest_on_seg(p1, a, b, cl);
    sphere_pair(p1, s1[0], cl, s2[0], dist, pos, frame);
    return;
  }
  // CAPSULE_CAPSULE
  T a1[3], d1[3], a2[3], d2[3], r[3];
  for (int k = 0; k < 3; ++k) {
    a1[k] = p1[k] - s1[1] * z1[k];
    d1[k] = T(2) * s1[1] * z1[k];
    a2[k] = p2[k] - s2[1] * z2[k];
    d2[k] = T(2) * s2[1] * z2[k];
  }
  for (int k = 0; k < 3; ++k) r[k] = a1[k] - a2[k];
  T a = dot3(d1, d1), ee = dot3(d2, d2), f = dot3(d2, r);
  T c = dot3(d1, r), b = dot3(d1, d2);
  T denom = a * ee - b * b;
  T s = denom > T(kMinVal)
            ? clampv((b * f - c * ee) / maxn(denom, T(kMinVal)), T(0), T(1))
            : T(0);
  T t = (b * s + f) / maxn(ee, T(kMinVal));
  if (t < T(0)) s = clampv(-c / maxn(a, T(kMinVal)), T(0), T(1));
  if (t > T(1)) s = clampv((b - c) / maxn(a, T(kMinVal)), T(0), T(1));
  t = clampv(t, T(0), T(1));
  T c1[3], c2[3];
  for (int k = 0; k < 3; ++k) {
    c1[k] = a1[k] + d1[k] * s;
    c2[k] = a2[k] + d2[k] * t;
  }
  sphere_pair(c1, s1[0], c2, s2[0], dist, pos, frame);
}

// a geom's world position p = xpos + xmat gpos and z axis, the third
// column of xmat (gmat), each entry as mat_mul computes it
template <typename T>
__device__ __forceinline__ void geom_pose(const Env<T>& e, int b, int unit,
                                          const T* gpos, const T* gmat,
                                          T* p, T* z) {
  T xm[9], r[3];
  for (int k = 0; k < 9; ++k) xm[k] = e.body(b, B_XMAT + k);
  mat_vec(xm, gpos, r);
  for (int k = 0; k < 3; ++k) p[k] = e.body(b, B_XPOS + k) + r[k];
  for (int i = 0; i < 3; ++i)
    z[i] = unit ? xm[3 * i + 2]
                : xm[3 * i] * gmat[2] + xm[3 * i + 1] * gmat[5] +
                      xm[3 * i + 2] * gmat[8];
}

// limit row r: J, aref and D
template <typename T>
__device__ __forceinline__ void limit_row(const Env<T>& e, const T* q,
                                          const T* v, int r) {
  const int nv = e.nv;
  const int* lq = e.I(I_LIM_QPOSADR);
  const int* ld = e.I(I_LIM_DOFADR);
  const T* sign = e.F(F_LIM_SIGN);
  const T* bound = e.F(F_LIM_BOUND);
  const T* margin = e.F(F_LIM_MARGIN);
  const T* invw = e.F(F_LIM_INVWEIGHT);
  const T* st = e.F(F_LIM_KBI);
  T pos = sign[r] * (q[lq[r]] - bound[r]) - margin[r];
  T vel = v[ld[r]] * sign[r];
  T k, b, imp;
  kbi(st + 8 * r, pos, &k, &b, &imp);
  T rreg = maxn(T(kMinVal), (T(1) - imp) / imp * invw[r]);
  for (int i = 0; i < nv; ++i) e.row(r, i) = i == ld[r] ? sign[r] : T(0);
  e.row(r, nv) = (-b) * vel - k * pos;
  e.row(r, nv + 1) = pos < T(0) ? T(1) / rreg : T(0);
}

// pair pi's contact rows, without their impedance: J per row, J v in the
// row's aref slot, and the contact's distance less the margin in its first
// row's D slot (pair_impedance finishes them)
template <typename T>
__device__ __forceinline__ void pair_rows(const Env<T>& e, const T* v,
                                          int pi) {
  const int nv = e.nv;
  const int* chain = e.I(I_BODY_CHAIN);
  const int* root = e.I(I_BODY_ROOT);
  const T* fric = e.F(F_PAIR_FRICTION);
  const T incm = e.F(F_PAIR_INCLUDEMARGIN)[pi];
  const int kind = e.I(I_PAIR_COLLIDER)[pi];
  const int b1 = e.I(I_PAIR_B1)[pi], b2 = e.I(I_PAIR_B2)[pi];
  const int nr = e.I(I_PAIR_CONDIM)[pi] == 1 ? 1 : 4;
  T p1[3], z1[3], p2[3], z2[3];
  geom_pose(e, b1, e.I(I_PAIR_G1_UNIT)[pi], e.F(F_PAIR_G1_POS) + 3 * pi,
            e.F(F_PAIR_G1_MAT) + 9 * pi, p1, z1);
  geom_pose(e, b2, e.I(I_PAIR_G2_UNIT)[pi], e.F(F_PAIR_G2_POS) + 3 * pi,
            e.F(F_PAIR_G2_MAT) + 9 * pi, p2, z2);
  const int c1 = chain[b1], c2 = chain[b2];
  const int r1 = root[b1], r2 = root[b2];
  int row = e.I(I_PAIR_ROW0)[pi];
  for (int c = 0; c < contacts_of(kind); ++c) {
    T dist, pr[3], fr[9];
    collide(kind, c, p1, z1, e.F(F_PAIR_G1_SIZE) + 3 * pi, p2, z2,
            e.F(F_PAIR_G2_SIZE) + 3 * pi, &dist, pr, fr);
    // the rows' J, dof by dof: the point's jacobian projected on the
    // frame (normal, two tangents); J v summed in dof order
    T jv[4] = {T(0), T(0), T(0), T(0)};
    for (int i = 0; i < nv; ++i) {
      T jd[3] = {T(0), T(0), T(0)};
      bool in1 = (c1 >> i) & 1, in2 = (c2 >> i) & 1;
      if (in1 || in2) {
        T ang[3], lin[3];
        for (int k = 0; k < 3; ++k) {
          ang[k] = e.dof(i, D_CDOF + k);
          lin[k] = e.dof(i, D_CDOF + 3 + k);
        }
        if (in2) {
          T arm[3], cr[3];
          for (int k = 0; k < 3; ++k) arm[k] = pr[k] - e.body(r2, B_SCOM + k);
          cross3(ang, arm, cr);
          for (int k = 0; k < 3; ++k) jd[k] = lin[k] + cr[k];
        }
        if (in1) {
          T arm[3], cr[3];
          for (int k = 0; k < 3; ++k) arm[k] = pr[k] - e.body(r1, B_SCOM + k);
          cross3(ang, arm, cr);
          for (int k = 0; k < 3; ++k) {
            T j1 = lin[k] + cr[k];
            jd[k] = in2 ? jd[k] - j1 : -j1;
          }
        }
      }
      const T jn = dot3(fr, jd);
      if (nr == 1) {
        e.row(row, i) = jn;
        jv[0] = jv[0] + jn * v[i];
        continue;
      }
      const T jt[2] = {dot3(fr + 3, jd), dot3(fr + 6, jd)};
#pragma unroll
      for (int fi = 0; fi < 2; ++fi) {
        const T mu = fric[2 * pi + fi];
#pragma unroll
        for (int sg = 0; sg < 2; ++sg) {
          T J = jn + (sg == 0 ? mu : -mu) * jt[fi];
          e.row(row + 2 * fi + sg, i) = J;
          jv[2 * fi + sg] = jv[2 * fi + sg] + J * v[i];
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      if (rr < nr) e.row(row + rr, nv) = jv[rr];
    e.row(row, nv + 1) = dist - incm;
    row += nr;
  }
}

// pair pi's rows finished: each contact's impedance from its distance
// (kbi), aref = -b J v - k pos and D.  Apart from pair_rows, so the call
// that pow may make runs with few values live
template <typename T>
__device__ __forceinline__ void pair_impedance(const Env<T>& e, int pi) {
  const int nv = e.nv;
  const T* st = e.F(F_PAIR_KBI) + 8 * pi;
  const int nr = e.I(I_PAIR_CONDIM)[pi] == 1 ? 1 : 4;
  const T inv = nr == 1 ? e.F(F_PAIR_INVWEIGHT)[pi] : e.F(F_PAIR_INVPYR)[pi];
  int row = e.I(I_PAIR_ROW0)[pi];
  for (int c = 0; c < contacts_of(e.I(I_PAIR_COLLIDER)[pi]); ++c) {
    const T pos_eff = e.row(row, nv + 1);
    T k, b, imp;
    kbi(st, pos_eff, &k, &b, &imp);
    T rreg = maxn(T(kMinVal), (T(1) - imp) / imp * inv);
    const T D = pos_eff < T(0) ? T(1) / rreg : T(0);
    for (int rr = 0; rr < nr; ++rr) {
      e.row(row + rr, nv) = (-b) * e.row(row + rr, nv) - k * pos_eff;
      e.row(row + rr, nv + 1) = D;
    }
    row += nr;
  }
}

// the rows: each pair's geometry and J a lane, then the limit rows and
// the pairs' impedances, a row or a pair a lane; then the indices of the
// rows that can carry force (D != 0, in row order, compacted by ballots)
// into e.live.  D stays fixed over the Newton solve, and a row with D = 0
// adds exactly zero to every cost, gradient, Hessian and line-search sum
// (the plain version's terms of it are all zero), so the solve reads only
// these rows.  Returns their count; ends synced.  kPairs: whether the
// model has contact pairs (without, the pairs' code is left out).
template <bool kPairs, typename T>
__device__ __forceinline__ int make_rows(const Env<T>& e, const T* q,
                                         const T* v) {
  if (kPairs) {
    for (int pi = e.l; pi < e.npair; pi += e.G) pair_rows(e, v, pi);
    e.sync();
  }
  for (int t = e.l; t < e.nlim + e.npair; t += e.G) {
    if (t < e.nlim)
      limit_row(e, q, v, t);
    else if (kPairs)
      pair_impedance(e, t - e.nlim);
  }
  e.sync();
  int n = 0;
  for (int base = 0; base < e.nrows; base += e.G) {
    const int r = base + e.l;
    const bool live = r < e.nrows && e.row(r, e.nv + 1) != T(0);
    const unsigned bal = e.ballot(live);
    if (live) e.live[n + __popc(bal & ((1u << e.l) - 1u))] = r;
    n += __popc(bal);
  }
  e.sync();
  return n;
}

// -- the projected Newton solve ---------------------------------------------

// 0.5 (x - qs)' M (x - qs) + the rows' quadratic costs at x, in double:
// lane i's row of the quadratic form and its strided live rows' costs,
// each summed over the group; every lane returns the same value
template <typename T>
__device__ __forceinline__ double total_cost(const Env<T>& e, const T* M,
                                             const double* qs,
                                             const double* x, int nd) {
  const int nv = e.nv;
  double quad = 0.0;
  for (int i = e.l; i < nv; i += e.G)
    for (int j = 0; j < nv; ++j)
      quad = quad + 0.5 * (x[i] - qs[i]) * double(M[i * nv + j]) *
                        (x[j] - qs[j]);
  double cost = 0.0;
  for (int k = e.l; k < nd; k += e.G) {
    const int r = e.live[k];
    double jx = 0.0;
    for (int i = 0; i < nv; ++i) jx = jx + double(e.row(r, i)) * x[i];
    double jar = jx - double(e.row(r, nv));
    if (jar < 0.0) cost = cost + 0.5 * double(e.row(r, nv + 1)) * jar * jar;
  }
  return e.sum(quad) + (nd ? e.sum(cost) : 0.0);
}

// jar = J x - aref of each live row (a row a lane), and the indices of
// those with jar < 0 in row order, compacted by ballots into e.act;
// returns their count.  Ends synced.
template <typename T>
__device__ __forceinline__ int active_rows(const Env<T>& e, const double* x,
                                           int nd) {
  const int nv = e.nv;
  int n = 0;
  for (int base = 0; base < nd; base += e.G) {
    const int k = base + e.l;
    bool a = false;
    int r = 0;
    if (k < nd) {
      r = e.live[k];
      double jx = 0.0;
      for (int i = 0; i < nv; ++i) jx = jx + double(e.row(r, i)) * x[i];
      double jar = jx - double(e.row(r, nv));
      e.jar(r) = jar;
      a = jar < 0.0;
    }
    const unsigned bal = e.ballot(a);
    if (a) e.act[n + __popc(bal & ((1u << e.l) - 1u))] = r;
    n += __popc(bal);
  }
  e.sync();
  return n;
}

// qacc (x) and qfrc_constraint (S_QFC) from the nd live rows, in double,
// from qs (S_QS) and the warm start
template <typename T>
__device__ __forceinline__ void newton(const Env<T>& e, const T* M,
                                       const T* warm, int nd) {
  const int nv = e.nv, l = e.l, G = e.G;
  const double tol = e.F(F_OPT)[O_TOL_SCALE];
  const int iterations = e.count(C_ITERATIONS);
  const int ls_iterations = e.count(C_LS_ITERATIONS);
  double* H = e.H();
  const double* qs = e.svec(S_QS);
  double* x = e.svec(S_X);
  double* grad = e.svec(S_GRAD);
  double* ng = e.svec(S_NG);
  double* p = e.svec(S_P);
  double* mp = e.svec(S_MP);
  double* x_try = e.svec(S_XTRY);
  double* qfc = e.svec(S_QFC);
  double c0 = total_cost(e, M, qs, qs, nd);
  for (int i = l; i < nv; i += G) x[i] = warm[i];
  e.sync();
  double cw = total_cost(e, M, qs, x, nd);
  bool use_warm = cw < c0;
  e.sync();
  for (int i = l; i < nv; i += G) x[i] = use_warm ? x[i] : qs[i];
  double cost = minn(cw, c0);
  e.sync();
  double improvement = INFINITY, gnorm = INFINITY;
  for (int it = 0; it < iterations && improvement > tol && gnorm > tol;
       ++it) {
    const int na = active_rows(e, x, nd);
    // the gradient's entries, then H's (a, b >= a), an entry a lane, each
    // summed over the rows with force in row order
    for (int t = l; t < nv + nv * (nv + 1) / 2; t += G) {
      if (t < nv) {
        double g = 0.0;
        for (int j = 0; j < nv; ++j)
          g = g + double(M[t * nv + j]) * (x[j] - qs[j]);
        for (int k = 0; k < na; ++k) {
          const int r = e.act[k];
          g = g + double(e.row(r, t)) * (double(e.row(r, nv + 1)) * e.jar(r));
        }
        grad[t] = g;
        ng[t] = -g;
        continue;
      }
      int a = 0, u = t - nv;
      while (u >= nv - a) {
        u -= nv - a;
        ++a;
      }
      const int b = a + u;
      double h = M[a * nv + b];
      for (int k = 0; k < na; ++k) {
        const int r = e.act[k];
        h = h + double(e.row(r, nv + 1)) * double(e.row(r, a)) *
                    double(e.row(r, b));
      }
      H[a * nv + b] = h;
      H[b * nv + a] = h;
    }
    e.sync();
    chol_solve(e, H, ng, p);
    for (int k = l; k < nd; k += G) {
      const int r = e.live[k];
      double jp = 0.0;
      for (int i = 0; i < nv; ++i) jp = jp + double(e.row(r, i)) * p[i];
      e.jp(r) = jp;
    }
    for (int i = l; i < nv; i += G) {
      double s = 0.0;
      for (int j = 0; j < nv; ++j) s = s + double(M[i * nv + j]) * p[j];
      mp[i] = s;
    }
    e.sync();
    double p_mp = 0.0;
    for (int i = 0; i < nv; ++i) p_mp = p_mp + p[i] * mp[i];
    // the exact line search: Newton steps on alpha.  Each step is a
    // function of alpha alone, so once a step leaves alpha as it was,
    // every later step would too: the loop stops there, with the bits the
    // full ls_iterations would give
    double alpha = 1.0;
    for (int k = 0; k < ls_iterations; ++k) {
      double d1 = 0.0;
      for (int i = 0; i < nv; ++i)
        d1 = d1 + ((x[i] - qs[i]) + alpha * p[i]) * mp[i];
      double s1 = 0.0, s2 = 0.0;
      for (int kk = l; kk < nd; kk += G) {
        const int r = e.live[kk];
        double jp = e.jp(r);
        double jar_a = e.jar(r) + alpha * jp;
        if (jar_a < 0.0) {
          double D = e.row(r, nv + 1);
          s1 = s1 + D * jar_a * jp;
          s2 = s2 + D * jp * jp;
        }
      }
      if (nd) {
        s1 = e.sum(s1);
        s2 = e.sum(s2);
      }
      d1 = d1 + s1;
      double d2 = p_mp + s2;
      const double next = alpha - d1 / maxn(d2, kMinVal);
      if (next == alpha) break;
      alpha = next;
    }
    alpha = clampv(alpha, 0.0, 4.0);
    for (int i = l; i < nv; i += G) x_try[i] = x[i] + alpha * p[i];
    e.sync();
    double cost_try = total_cost(e, M, qs, x_try, nd);
    double cost_new = cost;
    if (cost_try < cost) {
      for (int i = l; i < nv; i += G) x[i] = x_try[i];
      cost_new = cost_try;
    }
    improvement = cost - cost_new;
    double g2 = 0.0;
    for (int i = 0; i < nv; ++i) g2 = g2 + grad[i] * grad[i];
    gnorm = sqrt(g2);
    cost = cost_new;
    e.sync();
  }
  const int na = active_rows(e, x, nd);
  for (int i = l; i < nv; i += G) {
    double f = 0.0;
    for (int k = 0; k < na; ++k) {
      const int r = e.act[k];
      f = f - double(e.row(r, i)) * (double(e.row(r, nv + 1)) * e.jar(r));
    }
    qfc[i] = f;
  }
  e.sync();
}

// one forward: M, qacc, qfrc_smooth (V_QFS) and qfrc_constraint (S_QFC)
// at (q, v); one call site for Euler and RK4's stages.  Ends synced.
template <bool kPairs, typename T>
__device__ __forceinline__ void forward(const Env<T>& e, const T* q,
                                        const T* v, const T* warm,
                                        const T* ctrl, T* qacc) {
  const int nv = e.nv, l = e.l, G = e.G;
  T* M = e.M();
  T* qfs = e.vec(V_QFS);
  double* H = e.H();
  double* rhs = e.svec(S_RHS);
  double* qs = e.svec(S_QS);
  smooth(e, q, v, ctrl, M, qfs);
  for (int t = l; t < nv * nv; t += G) H[t] = M[t];
  for (int i = l; i < nv; i += G) rhs[i] = qfs[i];
  e.sync();
  chol_solve(e, H, rhs, qs);
  if (e.nrows == 0) {
    for (int i = l; i < nv; i += G) {
      qacc[i] = T(qs[i]);
      e.svec(S_QFC)[i] = 0.0;
    }
    e.sync();
    return;
  }
  const int nd = make_rows<kPairs>(e, q, v);
  newton(e, M, warm, nd);
  for (int i = l; i < nv; i += G) qacc[i] = T(e.svec(S_X)[i]);
  e.sync();
}

// the environment's shared memory: kBlockThreads / G environments a block,
// each env_bytes(...) from the block's start
__device__ __forceinline__ unsigned char* shared_base() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

// blocks an SM should hold at once, which caps the registers a thread:
// float32 without contact pairs four (128 registers, 16 warps an SM: one
// wave of cartpole's 512 blocks at B = 8192), with them three (168: the
// pairs' geometry needs more than 128 without spilling); float64 two
template <typename T, bool kPairs>
struct MinBlocks {
  static constexpr int value = kPairs ? 3 : 4;
};
template <bool kPairs>
struct MinBlocks<double, kPairs> {
  static constexpr int value = 2;
};

template <typename T, bool kPairs>
__global__ void __launch_bounds__(kBlockThreads, MinBlocks<T, kPairs>::value)
fastpath_step_kernel(const int* ip, const T* fp, const T* qpos,
                     const T* qvel, const T* warm, const T* ctrl,
                     T* qpos_out, T* qvel_out, T* warm_out, long long B,
                     int n_steps, int width, int envs_per_block) {
  const int g = threadIdx.x / width;
  const long long env = (long long)blockIdx.x * envs_per_block + g;
  if (env >= B) return;  // the whole group
  Env<T> e;
  e.ip = ip;
  e.fp = fp;
  e.nbody = ip[C_NBODY];
  e.nv = ip[C_NV];
  e.nu = ip[C_NU];
  e.nlim = ip[C_NLIM];
  e.npair = ip[C_NPAIR];
  e.nrows = ip[C_NROWS];
  const int nv = e.nv;
  unsigned char* mine =
      shared_base() + g * env_bytes(e.nbody, nv, e.nrows, sizeof(T));
  e.s = reinterpret_cast<T*>(mine);
  const long long tbytes =
      align16((long long)env_values(e.nbody, nv, e.nrows) * sizeof(T));
  e.a = reinterpret_cast<double*>(mine + tbytes);
  e.live = reinterpret_cast<int*>(
      mine + tbytes + align16((long long)solver_values(nv, e.nrows) * 8));
  e.act = e.live + e.nrows;
  e.o_dof = e.nbody * kBodyW;
  e.o_row = e.o_dof + nv * kDofW;
  e.o_mat = e.o_row + e.nrows * (nv + 2);
  e.o_vec = e.o_mat + nv * nv;
  e.G = width;
  e.l = threadIdx.x % width;
  e.base = (threadIdx.x % 32) / width * width;
  e.mask = width == 32 ? 0xffffffffu : ((1u << width) - 1u) << e.base;
  const int l = e.l, G = e.G;
  const int integrator = ip[C_INTEGRATOR];
  const bool has_damping = ip[C_HAS_DAMPING] != 0;
  const T dt = e.F(F_OPT)[O_TIMESTEP];
  const T* dtdamp = e.F(F_DOF_DTDAMPING);
  const T* c = ctrl + env * e.nu;
  T* q = e.vec(V_Q);
  T* v = e.vec(V_V);
  T* w = e.vec(V_W);
  T* qi = e.vec(V_QI);
  T* vi = e.vec(V_VI);
  T* qacc = e.vec(V_QACC);
  T* qvels = e.vec(V_QVELS);
  T* qaccs = e.vec(V_QACCS);
  for (int i = l; i < nv; i += G) {
    q[i] = qpos[env * nv + i];
    v[i] = qvel[env * nv + i];
    w[i] = warm[env * nv + i];
  }
  // RK4's tableau (engine.py): A = diag(1/2, 1/2, 1) below the diagonal,
  // B = (1/6, 1/3, 1/3, 1/6); its stages start from the first's qacc.
  // Euler is RK4's first stage alone: one call site of forward for both
  const T Bw[4] = {T(1.0 / 6), T(1.0 / 3), T(1.0 / 3), T(1.0 / 6)};
  const int stages = integrator == kIntegratorEuler ? 1 : 4;
  for (int s = 0; s < n_steps; ++s) {
    for (int st = 0; st < stages; ++st) {
      for (int i = l; i < nv; i += G) {
        if (st == 0) {
          vi[i] = v[i];
          qi[i] = q[i];
        } else {  // the tableau's one nonzero entry of the row
          const T a = st == 3 ? T(1) : T(0.5);
          vi[i] = v[i] + dt * (a * qaccs[(st - 1) * nv + i]);
          qi[i] = q[i] + dt * (a * qvels[(st - 1) * nv + i]);
        }
      }
      e.sync();
      forward<kPairs>(e, qi, vi, w, c, qacc);
      for (int i = l; i < nv; i += G) {
        if (st == 0) w[i] = qacc[i];
        qvels[st * nv + i] = vi[i];
        qaccs[st * nv + i] = qacc[i];
      }
      e.sync();
    }
    if (integrator == kIntegratorEuler) {
      if (has_damping) {  // (M + h diag(damping)) qacc = qfs + qfc
        const T* M = e.M();
        double* H = e.H();
        double* rhs = e.svec(S_RHS);
        double* x = e.svec(S_X);
        for (int t = l; t < nv * nv; t += G) {
          double h = M[t];
          if (t % (nv + 1) == 0) h = h + double(dtdamp[t / (nv + 1)]);
          H[t] = h;
        }
        for (int i = l; i < nv; i += G)
          rhs[i] = double(e.vec(V_QFS)[i]) + e.svec(S_QFC)[i];
        e.sync();
        chol_solve(e, H, rhs, x);
        for (int i = l; i < nv; i += G) qacc[i] = T(x[i]);
        e.sync();
      }
      for (int i = l; i < nv; i += G) {
        v[i] = v[i] + dt * qacc[i];
        q[i] = q[i] + dt * v[i];
      }
      e.sync();
      continue;
    }
    for (int i = l; i < nv; i += G) {
      T dvel = Bw[0] * qvels[i], dacc = Bw[0] * qaccs[i];
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        dvel = dvel + Bw[k] * qvels[k * nv + i];
        dacc = dacc + Bw[k] * qaccs[k * nv + i];
      }
      q[i] = q[i] + dt * dvel;
      v[i] = v[i] + dt * dacc;
    }
    e.sync();
  }
  for (int i = l; i < nv; i += G) {
    qpos_out[env * nv + i] = q[i];
    qvel_out[env * nv + i] = v[i];
    warm_out[env * nv + i] = w[i];
  }
}

// -- the launcher -------------------------------------------------------------

template <typename T>
int launch(const int* ip, const T* fp, const T* qpos, const T* qvel,
           const T* warm, const T* ctrl, T* qpos_out, T* qvel_out,
           T* warm_out, long long B, int n_steps, int nbody, int nv,
           int nrows, int npair, int width, int envs_per_block,
           cudaStream_t stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  auto kernel = npair > 0 ? fastpath_step_kernel<T, true>
                          : fastpath_step_kernel<T, false>;
  const long long bytes =
      envs_per_block * env_bytes(nbody, nv, nrows, sizeof(T));
  if (width < nv || width > 32 || (width & (width - 1)) != 0 ||
      envs_per_block < 1 || width * envs_per_block > kBlockThreads ||
      bytes > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B + envs_per_block - 1) / envs_per_block;
  kernel<<<(unsigned)blocks, width * envs_per_block, (size_t)bytes,
           stream>>>(
          ip, fp, qpos, qvel, warm, ctrl, qpos_out, qvel_out, warm_out, B,
          n_steps, width, envs_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fastpath_step_f32(const int* ip, const float* fp, const float* qpos,
                      const float* qvel, const float* warm,
                      const float* ctrl, float* qpos_out, float* qvel_out,
                      float* warm_out, long long B, int n_steps, int nbody,
                      int nv, int nrows, int npair, int width,
                      int envs_per_block, void* stream) {
  return launch<float>(ip, fp, qpos, qvel, warm, ctrl, qpos_out, qvel_out,
                       warm_out, B, n_steps, nbody, nv, nrows, npair, width,
                       envs_per_block, (cudaStream_t)stream);
}

int fastpath_step_f64(const int* ip, const double* fp, const double* qpos,
                      const double* qvel, const double* warm,
                      const double* ctrl, double* qpos_out,
                      double* qvel_out, double* warm_out, long long B,
                      int n_steps, int nbody, int nv, int nrows, int npair,
                      int width, int envs_per_block, void* stream) {
  return launch<double>(ip, fp, qpos, qvel, warm, ctrl, qpos_out, qvel_out,
                        warm_out, B, n_steps, nbody, nv, nrows, npair, width,
                        envs_per_block, (cudaStream_t)stream);
}

const char* fastpath_layout_names() { return kLayoutNames; }

long long fastpath_env_bytes(int nbody, int nv, int nrows, int elem) {
  return env_bytes(nbody, nv, nrows, elem);
}

const char* fastpath_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
