// The fused scalar-chain physics step of a small model, as one kernel.
//
// Replaces no Pallas kernel: it stands in for XLA's fusion of the
// straight-line program that dm_control_tpu/physics/fastpath.py:190
// (build_step) traces, which the JAX package runs for pendulum, cartpole,
// acrobot, reacher, walker and cheetah.  The port's plain version is
// dm_control_torch/physics/fastpath.py (FastStep.plain); the plan this
// kernel reads is built there (FastStep._build_plan) and the layout names
// of both are checked against each other when the library is loaded
// (fastpath_layout_names).
//
// Design: one thread an environment runs every step of one launch (the
// control step's substeps, or a reset's settle steps): FK, the smooth
// dynamics (com_pos, CRB with armature, com_vel, RNE, passive forces,
// actuation), the limit rows and the pyramidal contact rows (five
// colliders: plane-sphere, plane-capsule, sphere-sphere, sphere-capsule,
// capsule-capsule), the projected Newton solve with its exact line search,
// and Euler with implicit damping or RK4.  Each thread runs its own Newton
// loop and stops when its environment is no longer live, which gives the
// JAX package's masked batch result.  So no host sync and no launch per
// operation remains: a control step is one launch.
//
// Memory: arrays of the model's size (per body: frames, com, inertias,
// velocities, forces; per dof: anchors, axes, cdof; per row: J, aref, D,
// jar, J p) live in a scratch tensor the wrapper allocates, with the
// environment index fastest, so a warp's threads touch neighbouring
// addresses; nv-sized values (nv <= 10) and the nv x nv matrices (M, H,
// the Cholesky factor) are thread-local arrays.  The kernel allocates
// nothing.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32 and float64): the
// function reads the state (qpos, qvel, warm, ctrl) and writes qpos,
// qvel, warm once: 4 nv + nu values in and 3 nv out an environment, a few
// hundred bytes; its operations are counted in chip_smoke.py from the
// code (per substep: FK and the smooth dynamics, the rows, and per Newton
// iteration the gradient, the Hessian, the factor and the line search).
// Both give bounds of microseconds at B = 8192; the thread-per-environment
// design's cost is latency (one thread's long serial chain, thread-local
// arrays in local memory), which later work may split across a warp.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kNvMax = 10;
constexpr double kMinVal = 1e-15;
constexpr double kMinImp = 0.0001;
constexpr double kMaxImp = 0.9999;
constexpr int kThreads = 128;

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

// Scratch layout, one environment: per body kBodyW values, per dof kDofW,
// per row nv + 4 (J, then aref, D, jar, J p).
constexpr int kBodyW = 60;
enum BodySlot {
  B_XPOS = 0, B_XQUAT = 3, B_XMAT = 7, B_XIPOS = 16, B_SCOM = 19,
  B_CINERT = 22, B_CRB = 32, B_CVEL = 42, B_CACC = 48, B_CFRC = 54
};
constexpr int kDofW = 18;
enum DofSlot { D_XANCHOR = 0, D_XAXIS = 3, D_CDOF = 6, D_CDOFDOT = 12 };

long long scratch_elems(int nbody, int nv, int nrows) {
  return (long long)nbody * kBodyW + (long long)nv * kDofW +
         (long long)nrows * (nv + 4);
}

template <typename T>
struct Env {
  const int* ip;
  const T* fp;
  T* s;  // this environment's scratch, stride B
  long long B;
  int nbody, nv, nu, nlim, npair, nrows;

  __device__ __forceinline__ int count(int c) const { return ip[c]; }
  __device__ __forceinline__ const int* I(int a) const {
    return ip + ip[N_COUNTS + a];
  }
  __device__ __forceinline__ const T* F(int a) const {
    return fp + ip[N_COUNTS + N_INT_ARR + a];
  }
  __device__ __forceinline__ T& at(long long k) const { return s[k * B]; }
  __device__ __forceinline__ T& body(int b, int slot) const {
    return at((long long)b * kBodyW + slot);
  }
  __device__ __forceinline__ T& dof(int i, int slot) const {
    return at((long long)nbody * kBodyW + (long long)i * kDofW + slot);
  }
  __device__ __forceinline__ T& row(int r, int k) const {
    return at((long long)nbody * kBodyW + (long long)nv * kDofW +
              (long long)r * (nv + 4) + k);
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

// -- the unrolled Cholesky solve --------------------------------------------

// x = A^-1 b for an SPD n x n matrix A (row-major, lower triangle read);
// the pivot is sqrt(max(s, 1e-15)).  A may alias nothing else.  Called,
// not inlined: its three callers (qacc_smooth, the Newton direction, the
// implicit Euler step) would each carry a copy, and the build's time with
// them.
template <typename T>
__device__ __noinline__ void chol_solve(const T* A, const T* b, T* x,
                                        int n) {
  T L[kNvMax * kNvMax];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      T s = A[i * kNvMax + j];
      for (int k = 0; k < j; ++k)
        s = s - L[i * kNvMax + k] * L[j * kNvMax + k];
      if (i == j)
        L[i * kNvMax + i] = sqrt(maxn(s, T(kMinVal)));
      else
        L[i * kNvMax + j] = s / L[j * kNvMax + j];
    }
  }
  T y[kNvMax];
  for (int i = 0; i < n; ++i) {
    T s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i * kNvMax + k] * y[k];
    y[i] = s / L[i * kNvMax + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T s = y[i];
    for (int k = i + 1; k < n; ++k) s = s - L[k * kNvMax + i] * x[k];
    x[i] = s / L[i * kNvMax + i];
  }
}

// -- kinematics -------------------------------------------------------------

template <typename T>
__device__ void fk(const Env<T>& e, const T* q) {
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
  for (int k = 0; k < 3; ++k) e.body(0, B_XPOS + k) = T(0);
  e.body(0, B_XQUAT) = T(1);
  for (int k = 1; k < 4; ++k) e.body(0, B_XQUAT + k) = T(0);
  for (int b = 1; b < e.nbody; ++b) {
    int p = parent[b];
    T pq[4], pos[3], quat[4], r[3];
    for (int k = 0; k < 4; ++k) pq[k] = e.body(p, B_XQUAT + k);
    rotate(bpos + 3 * b, pq, r);
    for (int k = 0; k < 3; ++k) pos[k] = e.body(p, B_XPOS + k) + r[k];
    if (qunit[b]) {
      for (int k = 0; k < 4; ++k) quat[k] = pq[k];
    } else {
      quat_mul(pq, bquat + 4 * b, quat);
    }
    for (int j = jadr[b]; j < jadr[b] + jnum[b]; ++j) {
      const T* ja = jaxis + 3 * j;
      const T* jp = jpos + 3 * j;
      int a = qadr[j];
      if (jtype[j] == kJointSlide) {
        T axis_w[3], rp[3];
        rotate(ja, quat, axis_w);
        T dq = q[a] - qpos0[a];
        for (int k = 0; k < 3; ++k) pos[k] = pos[k] + axis_w[k] * dq;
        rotate(jp, quat, rp);
        for (int k = 0; k < 3; ++k) {
          e.dof(j, D_XANCHOR + k) = pos[k] + rp[k];
          e.dof(j, D_XAXIS + k) = axis_w[k];
        }
      } else {  // hinge
        T rp[3], anchor[3], aq[4], nq[4], ax[3];
        rotate(jp, quat, rp);
        for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + rp[k];
        T half = (q[a] - qpos0[a]) * T(0.5);
        T sh = sin(half);
        aq[0] = cos(half);
        for (int k = 0; k < 3; ++k) aq[1 + k] = ja[k] * sh;
        quat_mul(quat, aq, nq);
        for (int k = 0; k < 4; ++k) quat[k] = nq[k];
        rotate(jp, quat, rp);
        for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - rp[k];
        rotate(ja, quat, ax);
        for (int k = 0; k < 3; ++k) {
          e.dof(j, D_XANCHOR + k) = anchor[k];
          e.dof(j, D_XAXIS + k) = ax[k];
        }
      }
    }
    for (int k = 0; k < 3; ++k) e.body(b, B_XPOS + k) = pos[k];
    for (int k = 0; k < 4; ++k) e.body(b, B_XQUAT + k) = quat[k];
  }
}

// FK, com_pos, CRB, com_vel, RNE, passive and actuation: M (kNvMax-strided)
// and qfrc_smooth; the body and dof arrays stay in the scratch
template <typename T>
__device__ void smooth(const Env<T>& e, const T* q, const T* v,
                       const T* ctrl, T* M, T* qfs) {
  const int nb = e.nbody, nv = e.nv;
  const int* parent = e.I(I_BODY_PARENT);
  const int* root = e.I(I_BODY_ROOT);
  const int* iunit = e.I(I_BODY_IQUAT_UNIT);
  const int* jadr = e.I(I_BODY_JNTADR);
  const int* jnum = e.I(I_BODY_JNTNUM);
  const int* jtype = e.I(I_JNT_TYPE);
  const int* jdof = e.I(I_JNT_DOFADR);
  const int* jbody = e.I(I_JNT_BODY);
  const int* dbody = e.I(I_DOF_BODY);
  const int* dchain = e.I(I_DOF_CHAIN);
  const T* ipos = e.F(F_BODY_IPOS);
  const T* iquat = e.F(F_BODY_IQUAT);
  const T* mass = e.F(F_BODY_MASS);
  const T* inertia = e.F(F_BODY_INERTIA);
  const T* stm = e.F(F_BODY_SUBTREEMASS);
  fk(e, q);

  // xmat, xipos; com_pos accumulates m xipos from the leaves
  for (int b = 0; b < nb; ++b) {
    T quat[4], xm[9], r[3];
    for (int k = 0; k < 4; ++k) quat[k] = e.body(b, B_XQUAT + k);
    quat_to_mat(quat, xm);
    for (int k = 0; k < 9; ++k) e.body(b, B_XMAT + k) = xm[k];
    mat_vec(xm, ipos + 3 * b, r);
    for (int k = 0; k < 3; ++k) {
      T xi = e.body(b, B_XPOS + k) + r[k];
      e.body(b, B_XIPOS + k) = xi;
      e.body(b, B_SCOM + k) = mass[b] * xi;
    }
  }
  for (int b = nb - 1; b >= 1; --b)
    for (int k = 0; k < 3; ++k)
      e.body(parent[b], B_SCOM + k) =
          e.body(parent[b], B_SCOM + k) + e.body(b, B_SCOM + k);
  for (int b = 0; b < nb; ++b)
    for (int k = 0; k < 3; ++k)
      e.body(b, B_SCOM + k) = e.body(b, B_SCOM + k) / stm[b];
  // cinert about the root's com; crb starts as cinert
  for (int b = 0; b < nb; ++b) {
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
  // cdof, one a joint (nv == njnt)
  for (int j = 0; j < nv; ++j) {
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
  // CRB: composite inertias from the leaves; M over each dof's chain
  for (int b = nb - 1; b >= 1; --b)
    for (int k = 0; k < 10; ++k)
      e.body(parent[b], B_CRB + k) =
          e.body(parent[b], B_CRB + k) + e.body(b, B_CRB + k);
  const T* armature = e.F(F_DOF_ARMATURE);
  for (int i = 0; i < nv; ++i) {
    T crb[10], cd[6], f[6];
    for (int k = 0; k < 10; ++k) crb[k] = e.body(dbody[i], B_CRB + k);
    for (int k = 0; k < 6; ++k) cd[k] = e.dof(i, D_CDOF + k);
    inert_mul(crb, cd, f);
    for (int j = 0; j <= i; ++j) {
      T mij = T(0);
      if ((dchain[i] >> j) & 1) {
        T cj[6];
        for (int k = 0; k < 6; ++k) cj[k] = e.dof(j, D_CDOF + k);
        mij = dot6(f, cj);
      }
      M[i * kNvMax + j] = mij;
      M[j * kNvMax + i] = mij;
    }
  }
  for (int i = 0; i < nv; ++i)
    M[i * kNvMax + i] = M[i * kNvMax + i] + armature[i];

  // com_vel and RNE along the chains
  const T* grav = e.F(F_OPT) + O_GRAVITY;
  for (int k = 0; k < 3; ++k) {
    e.body(0, B_CVEL + k) = T(0);
    e.body(0, B_CVEL + 3 + k) = T(0);
    e.body(0, B_CACC + k) = T(0);
    e.body(0, B_CACC + 3 + k) = -grav[k];
  }
  for (int b = 1; b < nb; ++b) {
    int p = parent[b];
    T vel[6], a[6];
    for (int k = 0; k < 6; ++k) {
      vel[k] = e.body(p, B_CVEL + k);
      a[k] = e.body(p, B_CACC + k);
    }
    for (int j = jadr[b]; j < jadr[b] + jnum[b]; ++j) {
      int d = jdof[j];
      T cd[6], cdd[6];
      for (int k = 0; k < 6; ++k) cd[k] = e.dof(d, D_CDOF + k);
      motion_cross(vel, cd, cdd);
      for (int k = 0; k < 6; ++k) {
        e.dof(d, D_CDOFDOT + k) = cdd[k];
        vel[k] = vel[k] + cd[k] * v[d];
        a[k] = a[k] + cdd[k] * v[d];
      }
    }
    for (int k = 0; k < 6; ++k) {
      e.body(b, B_CVEL + k) = vel[k];
      e.body(b, B_CACC + k) = a[k];
    }
  }
  for (int b = 0; b < nb; ++b) {
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
  for (int b = nb - 1; b >= 1; --b)
    for (int k = 0; k < 6; ++k)
      e.body(parent[b], B_CFRC + k) =
          e.body(parent[b], B_CFRC + k) + e.body(b, B_CFRC + k);

  // passive, actuation; qfrc_smooth = passive - bias + actuation
  const T* damping = e.F(F_DOF_DAMPING);
  const T* stiffness = e.F(F_JNT_STIFFNESS);
  const T* spring = e.F(F_QPOS_SPRING);
  const int* qadr = e.I(I_JNT_QPOSADR);
  T passive[kNvMax], act[kNvMax];
  for (int i = 0; i < nv; ++i) {
    passive[i] = (-damping[i]) * v[i];
    act[i] = T(0);
  }
  for (int j = 0; j < nv; ++j)
    if (stiffness[j] != T(0))
      passive[jdof[j]] =
          passive[jdof[j]] - stiffness[j] * (q[qadr[j]] - spring[qadr[j]]);
  const int* adof = e.I(I_ACT_DOF);
  const T* gear = e.F(F_ACT_GEAR);
  const T* crange = e.F(F_ACT_CTRLRANGE);
  const T* frange = e.F(F_ACT_FORCERANGE);
  for (int u = 0; u < e.nu; ++u) {
    T c = clampv(ctrl[u], crange[2 * u], crange[2 * u + 1]);
    T force = clampv(gear[u] * c, frange[2 * u], frange[2 * u + 1]);
    act[adof[u]] = act[adof[u]] + force;
  }
  for (int i = 0; i < nv; ++i) {
    T cd[6], cf[6];
    for (int k = 0; k < 6; ++k) {
      cd[k] = e.dof(i, D_CDOF + k);
      cf[k] = e.body(dbody[i], B_CFRC + k);
    }
    qfs[i] = passive[i] - dot6(cd, cf) + act[i];
  }
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

// the colliders of physics/collision.py for geom 1 at (p1, m1) of size s1
// and geom 2 at (p2, m2) of size s2; returns the contact count (1 or 2)
template <typename T>
__device__ int collide(int kind, const T* p1, const T* m1, const T* s1,
                       const T* p2, const T* m2, const T* s2, T* dist,
                       T* pos, T* frame) {
  // a matrix's third column: m[2], m[5], m[8]
  T z1[3] = {m1[2], m1[5], m1[8]};
  T z2[3] = {m2[2], m2[5], m2[8]};
  if (kind == PLANE_SPHERE) {
    T r = s2[0], d[3];
    for (int k = 0; k < 3; ++k) d[k] = p2[k] - p1[k];
    T dd = dot3(z1, d) - r;
    dist[0] = dd;
    for (int k = 0; k < 3; ++k) pos[k] = p2[k] - z1[k] * (r + T(0.5) * dd);
    make_frame(z1, frame);
    return 1;
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
    for (int c = 0; c < 2; ++c) {
      T cap[3];
      for (int k = 0; k < 3; ++k) {
        T hla = hl * z2[k];
        cap[k] = c == 0 ? p2[k] + hla : p2[k] - hla;
      }
      T dd = dot3(cap, z1) - np1 - r;
      dist[c] = dd;
      for (int k = 0; k < 3; ++k)
        pos[3 * c + k] = cap[k] - z1[k] * (r + T(0.5) * dd);
      for (int k = 0; k < 9; ++k) frame[9 * c + k] = fr[k];
    }
    return 2;
  }
  if (kind == SPHERE_SPHERE) {
    sphere_pair(p1, s1[0], p2, s2[0], dist, pos, frame);
    return 1;
  }
  if (kind == SPHERE_CAPSULE) {
    T a[3], b[3], c[3];
    for (int k = 0; k < 3; ++k) {
      T half = s2[1] * z2[k];
      a[k] = p2[k] - half;
      b[k] = p2[k] + half;
    }
    closest_on_seg(p1, a, b, c);
    sphere_pair(p1, s1[0], c, s2[0], dist, pos, frame);
    return 1;
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
  return 1;
}

// a geom's world pose: p = xpos + xmat gpos, mat = xmat (gmat)
template <typename T>
__device__ __forceinline__ void geom_pose(const Env<T>& e, int b, int unit,
                                          const T* gpos, const T* gmat,
                                          T* p, T* mat) {
  T xm[9], r[3];
  for (int k = 0; k < 9; ++k) xm[k] = e.body(b, B_XMAT + k);
  mat_vec(xm, gpos, r);
  for (int k = 0; k < 3; ++k) p[k] = e.body(b, B_XPOS + k) + r[k];
  if (unit) {
    for (int k = 0; k < 9; ++k) mat[k] = xm[k];
  } else {
    mat_mul(xm, gmat, mat);
  }
}

// the limit rows, then each pair's contact rows: J, aref and D per row
template <typename T>
__device__ void make_rows(const Env<T>& e, const T* q, const T* v) {
  const int nv = e.nv;
  {
    const int* lq = e.I(I_LIM_QPOSADR);
    const int* ld = e.I(I_LIM_DOFADR);
    const T* sign = e.F(F_LIM_SIGN);
    const T* bound = e.F(F_LIM_BOUND);
    const T* margin = e.F(F_LIM_MARGIN);
    const T* invw = e.F(F_LIM_INVWEIGHT);
    const T* st = e.F(F_LIM_KBI);
    for (int r = 0; r < e.nlim; ++r) {
      T pos = sign[r] * (q[lq[r]] - bound[r]) - margin[r];
      T vel = v[ld[r]] * sign[r];
      T k, b, imp;
      kbi(st + 8 * r, pos, &k, &b, &imp);
      T rreg = maxn(T(kMinVal), (T(1) - imp) / imp * invw[r]);
      for (int i = 0; i < nv; ++i) e.row(r, i) = i == ld[r] ? sign[r] : T(0);
      e.row(r, nv) = (-b) * vel - k * pos;
      e.row(r, nv + 1) = pos < T(0) ? T(1) / rreg : T(0);
    }
  }
  const int* kind = e.I(I_PAIR_COLLIDER);
  const int* pb1 = e.I(I_PAIR_B1);
  const int* pb2 = e.I(I_PAIR_B2);
  const int* u1 = e.I(I_PAIR_G1_UNIT);
  const int* u2 = e.I(I_PAIR_G2_UNIT);
  const int* condim = e.I(I_PAIR_CONDIM);
  const int* row0 = e.I(I_PAIR_ROW0);
  const int* chain = e.I(I_BODY_CHAIN);
  const int* root = e.I(I_BODY_ROOT);
  const T* fric = e.F(F_PAIR_FRICTION);
  const T* incm = e.F(F_PAIR_INCLUDEMARGIN);
  const T* invw = e.F(F_PAIR_INVWEIGHT);
  const T* invpyr = e.F(F_PAIR_INVPYR);
  const T* st = e.F(F_PAIR_KBI);
  for (int pi = 0; pi < e.npair; ++pi) {
    int b1 = pb1[pi], b2 = pb2[pi];
    T p1[3], m1[9], p2[3], m2[9];
    geom_pose(e, b1, u1[pi], e.F(F_PAIR_G1_POS) + 3 * pi,
              e.F(F_PAIR_G1_MAT) + 9 * pi, p1, m1);
    geom_pose(e, b2, u2[pi], e.F(F_PAIR_G2_POS) + 3 * pi,
              e.F(F_PAIR_G2_MAT) + 9 * pi, p2, m2);
    T dist[2], cpos[6], frame[18];
    int ncon = collide(kind[pi], p1, m1, e.F(F_PAIR_G1_SIZE) + 3 * pi, p2,
                       m2, e.F(F_PAIR_G2_SIZE) + 3 * pi, dist, cpos, frame);
    int c1 = chain[b1], c2 = chain[b2];
    T com1[3], com2[3];
    for (int k = 0; k < 3; ++k) {
      com1[k] = e.body(root[b1], B_SCOM + k);
      com2[k] = e.body(root[b2], B_SCOM + k);
    }
    int row = row0[pi];
    for (int c = 0; c < ncon; ++c) {
      const T* pr = cpos + 3 * c;
      const T* fr = frame + 9 * c;
      // the point's jacobian projected on the frame, over every dof
      T jn[kNvMax], jt1[kNvMax], jt2[kNvMax];
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
            for (int k = 0; k < 3; ++k) arm[k] = pr[k] - com2[k];
            cross3(ang, arm, cr);
            for (int k = 0; k < 3; ++k) jd[k] = lin[k] + cr[k];
          }
          if (in1) {
            T arm[3], cr[3];
            for (int k = 0; k < 3; ++k) arm[k] = pr[k] - com1[k];
            cross3(ang, arm, cr);
            for (int k = 0; k < 3; ++k) {
              T j1 = lin[k] + cr[k];
              jd[k] = in2 ? jd[k] - j1 : -j1;
            }
          }
        }
        jn[i] = dot3(fr, jd);
        jt1[i] = dot3(fr + 3, jd);
        jt2[i] = dot3(fr + 6, jd);
      }
      T pos_eff = dist[c] - incm[pi];
      T k, b, imp;
      kbi(st + 8 * pi, pos_eff, &k, &b, &imp);
      bool act = pos_eff < T(0);
      if (condim[pi] == 1) {
        T jv = T(0);
        for (int i = 0; i < nv; ++i) {
          e.row(row, i) = jn[i];
          jv = jv + jn[i] * v[i];
        }
        T rreg = maxn(T(kMinVal), (T(1) - imp) / imp * invw[pi]);
        e.row(row, nv) = (-b) * jv - k * pos_eff;
        e.row(row, nv + 1) = act ? T(1) / rreg : T(0);
        ++row;
        continue;
      }
      T rreg = maxn(T(kMinVal), (T(1) - imp) / imp * invpyr[pi]);
      T D = act ? T(1) / rreg : T(0);
      for (int fi = 0; fi < 2; ++fi) {
        const T* jt = fi == 0 ? jt1 : jt2;
        T mu = fric[2 * pi + fi];
        for (int sg = 0; sg < 2; ++sg) {
          T smu = sg == 0 ? mu : -mu;
          T jv = T(0);
          for (int i = 0; i < nv; ++i) {
            T J = jn[i] + smu * jt[i];
            e.row(row, i) = J;
            jv = jv + J * v[i];
          }
          e.row(row, nv) = (-b) * jv - k * pos_eff;
          e.row(row, nv + 1) = D;
          ++row;
        }
      }
    }
  }
}

// -- the projected Newton solve ---------------------------------------------

// 0.5 (x - qs)' M (x - qs) + the rows' quadratic costs at x; writes each
// row's jar = J x - aref
template <typename T>
__device__ T total_cost(const Env<T>& e, const T* M, const T* qs,
                        const T* x) {
  const int nv = e.nv;
  T quad = T(0);
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j)
      quad = quad + T(0.5) * (x[i] - qs[i]) * M[i * kNvMax + j] *
                        (x[j] - qs[j]);
  T cost = T(0);
  for (int r = 0; r < e.nrows; ++r) {
    T jx = T(0);
    for (int i = 0; i < nv; ++i) jx = jx + e.row(r, i) * x[i];
    T jar = jx - e.row(r, nv);
    e.row(r, nv + 2) = jar;
    if (jar < T(0)) cost = cost + T(0.5) * e.row(r, nv + 1) * jar * jar;
  }
  return quad + cost;
}

// qacc and qfrc_constraint from the rows in the scratch
template <typename T>
__device__ void newton(const Env<T>& e, const T* M, const T* qs,
                       const T* warm, T* x, T* qfc) {
  const int nv = e.nv, nrows = e.nrows;
  const T tol = e.F(F_OPT)[O_TOL_SCALE];
  const int iterations = e.count(C_ITERATIONS);
  const int ls_iterations = e.count(C_LS_ITERATIONS);
  T c0 = total_cost(e, M, qs, qs);
  T cw = total_cost(e, M, qs, warm);
  bool use_warm = cw < c0;
  for (int i = 0; i < nv; ++i) x[i] = use_warm ? warm[i] : qs[i];
  T cost = minn(cw, c0);
  T improvement = T(INFINITY), gnorm = T(INFINITY);
  for (int it = 0; it < iterations && improvement > tol && gnorm > tol;
       ++it) {
    T grad[kNvMax], H[kNvMax * kNvMax], p[kNvMax], mp[kNvMax];
    for (int i = 0; i < nv; ++i) {
      T g = T(0);
      for (int j = 0; j < nv; ++j)
        g = g + M[i * kNvMax + j] * (x[j] - qs[j]);
      grad[i] = g;
      for (int j = 0; j < nv; ++j) H[i * kNvMax + j] = M[i * kNvMax + j];
    }
    for (int r = 0; r < nrows; ++r) {
      T jx = T(0);
      for (int i = 0; i < nv; ++i) jx = jx + e.row(r, i) * x[i];
      T jar = jx - e.row(r, nv);
      e.row(r, nv + 2) = jar;
      if (!(jar < T(0))) continue;  // no cost, gradient or curvature
      T D = e.row(r, nv + 1);
      T dcost = D * jar;
      for (int i = 0; i < nv; ++i) grad[i] = grad[i] + e.row(r, i) * dcost;
      for (int a = 0; a < nv; ++a) {
        T Ja = e.row(r, a);
        for (int b = a; b < nv; ++b) {
          T term = D * Ja * e.row(r, b);
          H[a * kNvMax + b] = H[a * kNvMax + b] + term;
          if (a != b) H[b * kNvMax + a] = H[b * kNvMax + a] + term;
        }
      }
    }
    T ng[kNvMax];
    for (int i = 0; i < nv; ++i) ng[i] = -grad[i];
    chol_solve(H, ng, p, nv);
    for (int r = 0; r < nrows; ++r) {
      T jp = T(0);
      for (int i = 0; i < nv; ++i) jp = jp + e.row(r, i) * p[i];
      e.row(r, nv + 3) = jp;
    }
    T p_mp = T(0);
    for (int i = 0; i < nv; ++i) {
      T s = T(0);
      for (int j = 0; j < nv; ++j) s = s + M[i * kNvMax + j] * p[j];
      mp[i] = s;
    }
    for (int i = 0; i < nv; ++i) p_mp = p_mp + p[i] * mp[i];
    // the exact line search: Newton steps on alpha
    T alpha = T(1);
    for (int k = 0; k < ls_iterations; ++k) {
      T d1 = T(0);
      for (int i = 0; i < nv; ++i)
        d1 = d1 + ((x[i] - qs[i]) + alpha * p[i]) * mp[i];
      T s1 = T(0), s2 = T(0);
      for (int r = 0; r < nrows; ++r) {
        T jp = e.row(r, nv + 3);
        T jar_a = e.row(r, nv + 2) + alpha * jp;
        if (jar_a < T(0)) {
          T D = e.row(r, nv + 1);
          s1 = s1 + D * jar_a * jp;
          s2 = s2 + D * jp * jp;
        }
      }
      d1 = d1 + s1;
      T d2 = p_mp + s2;
      alpha = alpha - d1 / maxn(d2, T(kMinVal));
    }
    alpha = clampv(alpha, T(0), T(4));
    T x_try[kNvMax];
    for (int i = 0; i < nv; ++i) x_try[i] = x[i] + alpha * p[i];
    T cost_try = total_cost(e, M, qs, x_try);
    T cost_new = cost;
    if (cost_try < cost) {
      for (int i = 0; i < nv; ++i) x[i] = x_try[i];
      cost_new = cost_try;
    }
    improvement = cost - cost_new;
    T g2 = T(0);
    for (int i = 0; i < nv; ++i) g2 = g2 + grad[i] * grad[i];
    gnorm = sqrt(g2);
    cost = cost_new;
  }
  for (int i = 0; i < nv; ++i) qfc[i] = T(0);
  for (int r = 0; r < nrows; ++r) {
    T jx = T(0);
    for (int i = 0; i < nv; ++i) jx = jx + e.row(r, i) * x[i];
    T jar = jx - e.row(r, nv);
    if (!(jar < T(0))) continue;
    T dcost = e.row(r, nv + 1) * jar;
    for (int i = 0; i < nv; ++i) qfc[i] = qfc[i] - e.row(r, i) * dcost;
  }
}

// one forward: M, qacc, qfrc_smooth and qfrc_constraint at (q, v); one call
// site for Euler and RK4's stages, so it is inlined once (called, not
// inlined, it read its arrays through generic pointers and ran slower)
template <typename T>
__device__ __forceinline__ void forward(const Env<T>& e, const T* q,
                                        const T* v, const T* warm,
                                        const T* ctrl, T* M, T* qacc,
                                        T* qfs, T* qfc) {
  smooth(e, q, v, ctrl, M, qfs);
  T qs[kNvMax];
  chol_solve(M, qfs, qs, e.nv);
  if (e.nrows == 0) {
    for (int i = 0; i < e.nv; ++i) {
      qacc[i] = qs[i];
      qfc[i] = T(0);
    }
    return;
  }
  make_rows(e, q, v);
  newton(e, M, qs, warm, qacc, qfc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fastpath_step_kernel(const int* ip, const T* fp, const T* qpos,
                     const T* qvel, const T* warm, const T* ctrl,
                     T* qpos_out, T* qvel_out, T* warm_out, T* scratch,
                     long long B, int n_steps) {
  long long env = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  Env<T> e;
  e.ip = ip;
  e.fp = fp;
  e.s = scratch + env;
  e.B = B;
  e.nbody = ip[C_NBODY];
  e.nv = ip[C_NV];
  e.nu = ip[C_NU];
  e.nlim = ip[C_NLIM];
  e.npair = ip[C_NPAIR];
  e.nrows = ip[C_NROWS];
  const int nv = e.nv;
  const int integrator = ip[C_INTEGRATOR];
  const bool has_damping = ip[C_HAS_DAMPING] != 0;
  const T dt = e.F(F_OPT)[O_TIMESTEP];
  const T* dtdamp = e.F(F_DOF_DTDAMPING);
  const T* c = ctrl + env * e.nu;
  T q[kNvMax], v[kNvMax], w[kNvMax];
  for (int i = 0; i < nv; ++i) {
    q[i] = qpos[env * nv + i];
    v[i] = qvel[env * nv + i];
    w[i] = warm[env * nv + i];
  }
  // RK4's tableau (engine.py); its stages start from the first's qacc.
  // Euler is RK4's first stage alone: one call site of forward for both
  const T A[3][3] = {{T(0.5), T(0), T(0)}, {T(0), T(0.5), T(0)},
                     {T(0), T(0), T(1)}};
  const T Bw[4] = {T(1.0 / 6), T(1.0 / 3), T(1.0 / 3), T(1.0 / 6)};
  const int stages = integrator == kIntegratorEuler ? 1 : 4;
  for (int s = 0; s < n_steps; ++s) {
    T M[kNvMax * kNvMax], qacc[kNvMax], qfs[kNvMax], qfc[kNvMax];
    T qvels[4][kNvMax], qaccs[4][kNvMax];
    for (int st = 0; st < stages; ++st) {
      T qi[kNvMax], vi[kNvMax];
      for (int i = 0; i < nv; ++i) {
        T dqvel = T(0), dvpos = T(0);
        bool first = true;
        for (int k = 0; k < st; ++k) {
          T a = A[st - 1][k];
          if (a == T(0)) continue;
          dqvel = first ? a * qaccs[k][i] : dqvel + a * qaccs[k][i];
          dvpos = first ? a * qvels[k][i] : dvpos + a * qvels[k][i];
          first = false;
        }
        vi[i] = st == 0 ? v[i] : v[i] + dt * dqvel;
        qi[i] = st == 0 ? q[i] : q[i] + dt * dvpos;
      }
      forward(e, qi, vi, w, c, M, qacc, qfs, qfc);
      for (int i = 0; i < nv; ++i) {
        if (st == 0) w[i] = qacc[i];
        qvels[st][i] = vi[i];
        qaccs[st][i] = qacc[i];
      }
    }
    if (integrator == kIntegratorEuler) {
      if (has_damping) {
        T rhs[kNvMax];
        for (int i = 0; i < nv; ++i) {
          M[i * kNvMax + i] = M[i * kNvMax + i] + dtdamp[i];
          rhs[i] = qfs[i] + qfc[i];
        }
        chol_solve(M, rhs, qacc, nv);
      }
      for (int i = 0; i < nv; ++i) {
        v[i] = v[i] + dt * qacc[i];
        q[i] = q[i] + dt * v[i];
      }
      continue;
    }
    for (int i = 0; i < nv; ++i) {
      T dvel = Bw[0] * qvels[0][i], dacc = Bw[0] * qaccs[0][i];
      for (int k = 1; k < 4; ++k) {
        dvel = dvel + Bw[k] * qvels[k][i];
        dacc = dacc + Bw[k] * qaccs[k][i];
      }
      q[i] = q[i] + dt * dvel;
      v[i] = v[i] + dt * dacc;
    }
  }
  for (int i = 0; i < nv; ++i) {
    qpos_out[env * nv + i] = q[i];
    qvel_out[env * nv + i] = v[i];
    warm_out[env * nv + i] = w[i];
  }
}

template <typename T>
int launch(const int* ip, const T* fp, const T* qpos, const T* qvel,
           const T* warm, const T* ctrl, T* qpos_out, T* qvel_out,
           T* warm_out, T* scratch, long long B, int n_steps,
           cudaStream_t stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  long long blocks = (B + kThreads - 1) / kThreads;
  fastpath_step_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      ip, fp, qpos, qvel, warm, ctrl, qpos_out, qvel_out, warm_out, scratch,
      B, n_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fastpath_step_f32(const int* ip, const float* fp, const float* qpos,
                      const float* qvel, const float* warm,
                      const float* ctrl, float* qpos_out, float* qvel_out,
                      float* warm_out, float* scratch, long long B,
                      int n_steps, void* stream) {
  return launch<float>(ip, fp, qpos, qvel, warm, ctrl, qpos_out, qvel_out,
                       warm_out, scratch, B, n_steps,
                       (cudaStream_t)stream);
}

int fastpath_step_f64(const int* ip, const double* fp, const double* qpos,
                      const double* qvel, const double* warm,
                      const double* ctrl, double* qpos_out,
                      double* qvel_out, double* warm_out, double* scratch,
                      long long B, int n_steps, void* stream) {
  return launch<double>(ip, fp, qpos, qvel, warm, ctrl, qpos_out, qvel_out,
                        warm_out, scratch, B, n_steps,
                        (cudaStream_t)stream);
}

const char* fastpath_layout_names() { return kLayoutNames; }

long long fastpath_scratch_elems(int nbody, int nv, int nrows) {
  return scratch_elems(nbody, nv, nrows);
}

const char* fastpath_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
