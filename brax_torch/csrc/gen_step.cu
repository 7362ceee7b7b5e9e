// nvcc-flags: --fmad=false
//
// The generalized-coordinate env step of brax_torch.v2: all n_frames physics
// frames of a MuJoCo-style articulated system, for a batch of envs, in one
// launch.  It replaces the Pallas TPU kernel
// brax_tpu/v2/generalized/kernels.py::_build_tile_frames (launched by the
// pallas_call at kernels.py:1164).
//
// Each frame, per env: forward kinematics; sphere-plane contact points;
// the CoM-frame inertias, dof axes and velocities; the CRB mass matrix; its
// inverse by Newton-Schulz warm-started from the carried inverse; the
// contact (4 pyramid rows per point) and joint-limit rows; the RNE bias
// force, passive and motor forces; the constraint system A = J M^-1 J^T +
// diag and b; FISTA for the contact forces; damping folded into M^-1; and
// semi-implicit Euler.  After the last frame: kinematics, velocities and
// contact points of the final state.
//
// A first design gave each env one thread: 4096 envs were 128 warps, one per
// SM, each running ~274k dependent operations alone over a 14 KB stack in
// local memory (2.54 ms for ant at 4096 envs on an H100).
//
// The design: a warp per env, its workspace in shared memory.
// - The 32 lanes split the work that is independent within one env: the
//   products (a lane owns a column strip of outputs, one load of b[k][j]
//   serving the strip's rows), the rows and columns of FISTA's A y + b and
//   A^T r, the entries of J M^-1, of M and of A's upper triangle, the links
//   and dofs of the per-link stages.  The tree walks (kinematics and
//   velocities) run level by level, the links of one depth at once.
// - Every sum keeps the plain version's order: a lane sums its output over
//   k from the left, and each sum to one scalar (Newton-Schulz's trace and
//   norms, FISTA's objective, gradient step and distance) runs on one lane
//   in index order, over products the lanes wrote to shared memory,
//   independent sums on neighbouring lanes at once.  With --fmad=false
//   every output rounds as kernels.py::gen_step_plain does, bit for bit.
// - Every branch (the line search's early exit, the Newton-Schulz
//   convergence test, its r0n > 1 fallback) is uniform within the warp.
// - A block holds `envs_per_block` warps (from the launch).  The scene's
//   float table and its structure (masks and index tables, `Scene`) are
//   staged once per block, where lanes index them by link or dof; the
//   block loads its envs' inputs and stores their outputs together, so
//   that the (field, env) layout moves in runs of envs.
// The workspace's size per env (GS_WS_BYTES) and per block (GS_FIXED_BYTES)
// come from kernels.py::scene_header, which reckons the launch from them.
//
// What bounds it now: one env's chain of dependent operations, then the
// SM's issue rate.  A wave of blocks with up to ~11 warps resident per SM
// takes ~0.23 ms for ant's 5 frames, whatever the count; with 16 (the most
// that ~128 registers a thread allow) ~0.28 ms, each warp issuing two
// instructions per multiply-add (--fmad=false) and its serial sums on one
// lane (PERF.md, the envs-per-block sweep of chip_smoke.py).

#include <cuda_runtime.h>

#ifndef GS_NL
#error "gen_step.cu is compiled through brax_torch/v2/generalized/kernels.py::kernel_source"
#endif

namespace {

constexpr int NL = GS_NL, NQ = GS_NQ, ND = GS_ND, NC = GS_NC, NA = GS_NA, NR = GS_NR;
constexpr int NLIM = GS_NLIM, DEPTH = GS_DEPTH;
constexpr int NC1 = NC > 0 ? NC : 1, NA1 = NA > 0 ? NA : 1, NR1 = NR > 0 ? NR : 1;
constexpr int NLIM1 = NLIM > 0 ? NLIM : 1;
constexpr unsigned FULL = 0xffffffffu;
// the launch bound: at most this many warps (envs) per block
constexpr int MAX_ENVS_PER_BLOCK = 16;
// dynamic shared memory one block may take on sm_90
constexpr int MAX_SMEM = 232448;
static_assert(ND <= 64 && NL <= 64, "the dof and link masks are 64-bit");

// float table (kernels.py::pack_tables)
constexpr int LINK_SIZE = 39, DOF_SIZE = 13, ACT_SIZE = 3, CONTACT_SIZE = 23;
constexpr int T_DT = 0, T_GRAV = 1, T_TOTM = 4;
constexpr int T_LINK = 5;
constexpr int T_DOF = T_LINK + NL * LINK_SIZE;
constexpr int T_ACT = T_DOF + ND * DOF_SIZE;
constexpr int T_CON = T_ACT + NA * ACT_SIZE;
constexpr int T_SIZE = T_CON + NC * CONTACT_SIZE;
constexpr int T_BYTES = (T_SIZE * 4 + 15) / 16 * 16;
// link record
constexpr int L_TPOS = 0, L_TROT = 3, L_JPOS = 7, L_JROT = 10, L_IPOS = 14, L_IROT = 17,
              L_I = 21, L_MASS = 30, L_CRBM = 31, L_RJPOS = 32, L_RJROT = 35;
// dof record
constexpr int D_ANG = 0, D_VEL = 3, D_ARM = 6, D_DAMP = 7, D_STIFF = 8, D_DCOL = 9, D_IW = 10,
              D_LO = 11, D_HI = 12;
// contact record
constexpr int C_LPOS = 0, C_RAD = 3, C_NRM = 4, C_PPOS = 7, C_DIRS = 10, C_DIAG = 22;

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};
struct M3 {
  float m[3][3];
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 rotate(V3 v, Q4 q) {
  // 2 (u.v) u + (s^2 - u.u) v + 2 s (u x v)
  V3 u = {q.x, q.y, q.z};
  float uv = dot3(u, v), uu = dot3(u, u), s = q.w;
  V3 c = cross(u, v);
  return {2.0f * (uv * u.x) + (s * s - uu) * v.x + 2.0f * s * c.x,
          2.0f * (uv * u.y) + (s * s - uu) * v.y + 2.0f * s * c.y,
          2.0f * (uv * u.z) + (s * s - uu) * v.z + 2.0f * s * c.z};
}
__device__ __forceinline__ Q4 qmul(Q4 u, Q4 v) {
  return {u.w * v.w - u.x * v.x - u.y * v.y - u.z * v.z,
          u.w * v.x + u.x * v.w + u.y * v.z - u.z * v.y,
          u.w * v.y - u.x * v.z + u.y * v.w + u.z * v.x,
          u.w * v.z + u.x * v.y - u.y * v.x + u.z * v.w};
}
__device__ __forceinline__ float sumsq4(Q4 q) {
  return q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z;
}
__device__ __forceinline__ Q4 normalize(Q4 q) {
  // maths.normalize_with_norm: exactly unchanged when |q| == 1 is exact
  bool zero = fabsf(q.w) <= 1e-8f && fabsf(q.x) <= 1e-8f && fabsf(q.y) <= 1e-8f &&
              fabsf(q.z) <= 1e-8f;
  Q4 s = zero ? Q4{1.0f, 1.0f, 1.0f, 1.0f} : q;
  float n = zero ? 0.0f : sqrtf(sumsq4(s));
  float den = n + 1e-6f * (n == 0.0f ? 1.0f : 0.0f);
  return {q.w / den, q.x / den, q.y / den, q.z / den};
}
__device__ __forceinline__ Q4 quat_rot_axis(V3 axis, float angle) {
  float s = sinf(angle / 2.0f), w = cosf(angle / 2.0f);
  return {w, axis.x * s, axis.y * s, axis.z * s};
}

__device__ __forceinline__ M3 operator+(const M3& a, const M3& b) {
  M3 c;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c.m[i][j] = a.m[i][j] + b.m[i][j];
  return c;
}

__device__ __forceinline__ V3 ld3(const float* t) { return {t[0], t[1], t[2]}; }
__device__ __forceinline__ Q4 ld4(const float* t) { return {t[0], t[1], t[2], t[3]}; }

__device__ __forceinline__ bool bit(unsigned long long mask, int i) { return (mask >> i) & 1ull; }

// -- shared memory ---------------------------------------------------------------
//
// Every member is 16-byte aligned, so that each struct's size is the sum of
// its members' sizes rounded up to 16 bytes and each union's the largest of
// its structs': kernels.py::workspace_bytes reckons GS_WS_BYTES that way.

#define A16 alignas(16)

// per block, after the float table: the tree and row structure, as bit
// masks and as copies of the header's tables (lanes index these by link or
// dof: from shared memory that costs one access, from constant memory one
// per distinct index)
struct Scene {
  A16 unsigned long long anc[NL];   // bit d: dof d is on link l's ancestor chain
  A16 unsigned long long sub[NL];   // bit k: link k is in link l's subtree
  A16 unsigned long long pair[ND];  // bit j <= i: dofs i and j share a chain
  A16 unsigned long long row[NR1];  // bit d: constraint row r touches dof d
  A16 int ltype[NL];
  A16 int parent[NL];
  A16 int com_parent[NL];
  A16 int q_off[NL];
  A16 int qd_off[NL];
  A16 int depth[NL];
  A16 int dof_link[ND];
  A16 int has_stiff[ND];
  A16 int c_link[NC1];
  A16 int lim_q[NLIM1];
  A16 int lim_d[NLIM1];
};

// per env
struct Work {
  // carried from frame to frame
  A16 float q[NQ];
  A16 float qd[ND];
  A16 float act[NA1];
  A16 float minv[ND * ND];
  // kinematics and CoM-frame terms of the frame's q (after the last frame,
  // of the final q: outputs)
  A16 V3 xpos[NL];
  A16 Q4 xrot[NL];
  A16 V3 cpos[NC1];
  A16 float cpen[NC1];
  A16 V3 com;
  A16 M3 cinr_i[NL];
  A16 V3 cinr_h[NL];
  A16 V3 cdof_a[ND];
  A16 V3 cdof_v[ND];
  A16 V3 cdofd_a[ND];
  A16 V3 cdofd_v[ND];
  A16 V3 cd_a[NL];
  A16 V3 cd_v[NL];
  A16 float mx[ND * ND];
  A16 float qf[ND];
  A16 float qfc[ND];
  // scratch of one stage at a time
  union {
    struct {  // transform_com
      A16 V3 xi_pos[NL];
      A16 Q4 xi_rot[NL];
      A16 V3 cq_a[ND];
      A16 V3 cq_v[ND];
    } tc;
    struct {  // mass_matrix
      A16 M3 crb_i[NL];
      A16 V3 crb_h[NL];
      A16 V3 f_a[ND];
      A16 V3 f_v[ND];
    } mm;
    struct {  // inv_ns and the damping fold
      A16 float t1[ND * ND];
      A16 float t2[ND * ND];
      A16 float p1[ND * ND];
      A16 float p2[ND * ND];
      A16 float p3[ND];
    } ns;
    struct {  // bias_forces
      A16 V3 cfrc_a[NL];
      A16 V3 cfrc_v[NL];
    } rne;
    struct {  // constraint_forces and fista
      A16 float jac[NR1 * ND];
      A16 float jm[NR1 * ND];
      A16 float amat[NR1 * NR1];
      A16 float pos_r[NR1];
      A16 float diag_r[NR1];
      A16 float aref[NR1];
      A16 float diag_add[NR1];
      A16 float b[NR1];
      A16 float x[NR1];
      A16 float y[NR1];
      A16 float r[NR1];
      A16 float g[NR1];
      A16 float cand[NR1];
      A16 float cand0[NR1];
      A16 float p1[NR1];
      A16 float p2[NR1];
      A16 float p3[NR1];
    } con;
    struct {  // final velocities
      A16 V3 xd_ang[NL];
      A16 V3 xd_vel[NL];
    } fin;
  } u;
};

static_assert(sizeof(Work) == GS_WS_BYTES, "kernels.py::workspace_bytes disagrees with Work");
constexpr int FIXED_BYTES = T_BYTES + (int)sizeof(Scene);
static_assert(FIXED_BYTES == GS_FIXED_BYTES, "kernels.py::block_fixed_bytes disagrees");

// -- warp helpers ------------------------------------------------------------------

// a[0] + a[1] + ... + a[N - 1], from the left; a is 16-byte aligned
template <int N>
__device__ __forceinline__ float lane_sum(const float* a) {
  float s = a[0];
#pragma unroll
  for (int i = 1; i < (N < 4 ? N : 4); ++i) s = s + a[i];
#pragma unroll
  for (int i = 4; i + 4 <= N; i += 4) {
    float4 v = *reinterpret_cast<const float4*>(a + i);
    s = s + v.x;
    s = s + v.y;
    s = s + v.z;
    s = s + v.w;
  }
#pragma unroll
  for (int i = (N < 4 ? N : 4 + (N - 4) / 4 * 4); i < N; ++i) s = s + a[i];
  return s;
}

// f(p, owned) for p = lane, lane + 32, ... < N, as straight-line code so
// that the compiler may interleave a lane's independent entries: a lane past
// the end computes entry N - 1 again with owned false, and stores nothing.
template <int N, typename F>
__device__ __forceinline__ void per_lane(int lane, F f) {
#pragma unroll
  for (int r = 0; r < (N + 31) / 32; ++r) {
    int p = lane + 32 * r;
    f(p < N ? p : N - 1, p < N);
  }
}

// (i, j) advanced by `step` places along the upper triangle of an n x n
// matrix, row by row; i == n past its end
__device__ __forceinline__ void upper_next(int& i, int& j, int step, int n) {
  j += step;
  while (j >= n && i < n) {
    ++i;
    j = j - n + i;
  }
}

// c = a @ b, ND x ND row-major, each entry summed over k from the left.  A
// lane owns column j of a strip of MM_R rows: one load of b[k][j] serves
// MM_R entries.  UPPER: the product is known to be symmetric; only entries
// i <= j are stored, each also at (j, i).
constexpr int MM_G = ND < 32 ? 32 / ND : 1;  // row strips
constexpr int MM_R = (ND + MM_G - 1) / MM_G;  // rows per strip
template <bool UPPER>
__device__ void matmul(const float* a, const float* b, float* c, int lane) {
  for (int q = lane; q < ND * MM_G; q += 32) {
    int j = q % ND, i0 = q / ND * MM_R;
    float acc[MM_R];
#pragma unroll
    for (int r = 0; r < MM_R; ++r) acc[r] = a[min(i0 + r, ND - 1) * ND] * b[j];
#pragma unroll
    for (int k = 1; k < ND; ++k) {
      float bk = b[k * ND + j];
#pragma unroll
      for (int r = 0; r < MM_R; ++r) acc[r] = acc[r] + a[min(i0 + r, ND - 1) * ND + k] * bk;
    }
#pragma unroll
    for (int r = 0; r < MM_R; ++r) {
      int i = i0 + r;
      if (i < ND && (!UPPER || i <= j)) {
        c[i * ND + j] = acc[r];
        if (UPPER) c[j * ND + i] = acc[r];
      }
    }
  }
}

// The sum t(k0) + t(k1) + ... over the k < N with bit k of mask set, from the
// left; zero when no bit is set.  N is a compile-time bound, so the loop
// unrolls: a loop over the set bits alone runs as long as the warp's
// longest mask and cannot load ahead.
template <int N, typename T, typename F>
__device__ __forceinline__ T masked_sum(unsigned long long mask, T zero, F t) {
  T v = zero;
  bool first = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!bit(mask, k)) continue;
    T tk = t(k);
    v = first ? tk : v + tk;
    first = false;
  }
  return v;
}

// -- kinematics --------------------------------------------------------------

// World transforms of q: each link's joint transform at once, then the
// tree, one depth at a time.
__device__ void fk(const float* T, const Scene& S, const float* q, V3* xpos, Q4* xrot, int lane) {
  for (int l = lane; l < NL; l += 32) {
    const float* L = T + T_LINK + l * LINK_SIZE;
    int qo = S.q_off[l];
    V3 jp;
    Q4 jr;
    if (S.ltype[l] == 0) {
      jp = {q[qo], q[qo + 1], q[qo + 2]};
      jr = {q[qo + 3], q[qo + 4], q[qo + 5], q[qo + 6]};
    } else {
      int d0 = S.qd_off[l];
      for (int i = 0; i < S.ltype[l]; ++i) {
        const float* D = T + T_DOF + (d0 + i) * DOF_SIZE;
        float qi = q[qo + i];
        Q4 rot_i = normalize(quat_rot_axis(ld3(D + D_ANG), qi));
        V3 pos_i = ld3(D + D_VEL) * qi;
        if (i == 0) {
          jp = pos_i;
          jr = rot_i;
        } else {
          jp = jp + rotate(pos_i, jr);
          jr = qmul(jr, rot_i);
        }
      }
    }
    V3 jpos = ld3(L + L_JPOS);
    Q4 trot = ld4(L + L_TROT);
    jp = (jp + jpos) - rotate(jpos, jr);
    xpos[l] = ld3(L + L_TPOS) + rotate(jp, trot);
    xrot[l] = qmul(trot, jr);
  }
  __syncwarp();
  for (int depth = 1; depth <= DEPTH; ++depth) {
    for (int l = lane; l < NL; l += 32) {
      if (S.depth[l] != depth) continue;
      int par = S.parent[l];
      V3 jp = xpos[l];
      Q4 jr = xrot[l];
      xpos[l] = xpos[par] + rotate(jp, xrot[par]);
      xrot[l] = qmul(xrot[par], jr);
    }
    __syncwarp();
  }
  for (int l = lane; l < NL; l += 32) xrot[l] = normalize(xrot[l]);
  __syncwarp();
}

__device__ void fk_vel(const float* T, const Scene& S, const float* q, const float* qd, const V3* xpos,
                       const Q4* xrot, V3* xd_ang, V3* xd_vel, int lane) {
  for (int l = lane; l < NL; l += 32) {
    int d0 = S.qd_off[l], qo = S.q_off[l];
    V3 ja, jv;
    if (S.ltype[l] == 0) {
      ja = {qd[d0 + 3], qd[d0 + 4], qd[d0 + 5]};
      jv = {qd[d0], qd[d0 + 1], qd[d0 + 2]};
    } else {
      const float* D = T + T_DOF + d0 * DOF_SIZE;
      ja = ld3(D + D_ANG) * qd[d0];
      jv = ld3(D + D_VEL) * qd[d0];
      for (int i = 1; i < S.ltype[l]; ++i) {
        int d = d0 + i;
        const float* Di = T + T_DOF + d * DOF_SIZE;
        float qi = q[qo + i];
        Q4 rot_i = normalize(quat_rot_axis(ld3(Di + D_ANG), qi));
        V3 pos_i = ld3(Di + D_VEL) * qi;
        V3 a_i = ld3(Di + D_ANG) * qd[d];
        V3 v_i = ld3(Di + D_VEL) * qd[d];
        ja = ja + rotate(a_i, rot_i);
        jv = jv + rotate(v_i + cross(pos_i, a_i), rot_i);
      }
    }
    xd_ang[l] = ja;
    xd_vel[l] = jv;
  }
  __syncwarp();
  for (int depth = 1; depth <= DEPTH; ++depth) {
    for (int l = lane; l < NL; l += 32) {
      if (S.depth[l] != depth) continue;
      int par = S.parent[l];
      V3 ja = xd_ang[l], jv = xd_vel[l];
      xd_ang[l] = xd_ang[par] + rotate(ja, xrot[l]);
      xd_vel[l] = xd_vel[par] + rotate(jv + cross(xpos[l], ja), xrot[l]);
    }
    __syncwarp();
  }
}

__device__ void contacts(const float* T, const Scene& S, const V3* xpos, const Q4* xrot, V3* cpos, float* cpen,
                         int lane) {
  for (int c = lane; c < NC; c += 32) {
    const float* C = T + T_CON + c * CONTACT_SIZE;
    int l = S.c_link[c];
    V3 n = ld3(C + C_NRM);
    float r = C[C_RAD];
    V3 spos = xpos[l] + rotate(ld3(C + C_LPOS), xrot[l]);
    float pen = r - dot3(spos - ld3(C + C_PPOS), n);
    cpos[c] = spos - n * (r - 0.5f * pen);
    cpen[c] = pen;
  }
  __syncwarp();
}

// -- CoM-frame terms -----------------------------------------------------------

__device__ void transform_com(const float* T, const Scene& S, Work& w, int lane) {
  auto& s = w.u.tc;
  for (int l = lane; l < NL; l += 32) {
    const float* L = T + T_LINK + l * LINK_SIZE;
    s.xi_pos[l] = w.xpos[l] + rotate(ld3(L + L_IPOS), w.xrot[l]);
    s.xi_rot[l] = qmul(w.xrot[l], ld4(L + L_IROT));
  }
  __syncwarp();
  if (lane < 3) {  // one component per lane
    const float* xi = reinterpret_cast<const float*>(s.xi_pos);
    float c = xi[lane] * T[T_LINK + L_MASS];
    for (int l = 1; l < NL; ++l) c = c + xi[3 * l + lane] * T[T_LINK + l * LINK_SIZE + L_MASS];
    reinterpret_cast<float*>(&w.com)[lane] = c / T[T_TOTM];
  }
  __syncwarp();
  const V3 com = w.com;

  for (int l = lane; l < NL; l += 32) {
    const float* L = T + T_LINK + l * LINK_SIZE;
    V3 pos = s.xi_pos[l] - com;
    Q4 qr = s.xi_rot[l];
    float d = sumsq4(qr);
    float sc = 2.0f / d;
    float xs = qr.x * sc, ys = qr.y * sc, zs = qr.z * sc;
    float wx = qr.w * xs, wy = qr.w * ys, wz = qr.w * zs;
    float xx = qr.x * xs, xy = qr.x * ys, xz = qr.x * zs;
    float yy = qr.y * ys, yz = qr.y * zs, zz = qr.z * zs;
    float r[3][3] = {{1.0f - (yy + zz), xy - wz, xz + wy},
                     {xy + wz, 1.0f - (xx + zz), yz - wx},
                     {xz - wy, yz + wx, 1.0f - (xx + yy)}};
    float ri[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        ri[a][b] = r[a][0] * L[L_I + b] + r[a][1] * L[L_I + 3 + b] + r[a][2] * L[L_I + 6 + b];
    V3 h[3] = {cross(pos, V3{-1.0f, -0.0f, -0.0f}), cross(pos, V3{-0.0f, -1.0f, -0.0f}),
               cross(pos, V3{-0.0f, -0.0f, -1.0f})};
    float m = L[L_MASS];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        w.cinr_i[l].m[a][b] = (ri[a][0] * r[b][0] + ri[a][1] * r[b][1] + ri[a][2] * r[b][2]) +
                              dot3(h[a], h[b]) * m;
    w.cinr_h[l] = pos * m;

    // the link's dof axes in the CoM frame
    int par = S.com_parent[l];
    V3 jf_pos;
    Q4 jf_rot;
    if (par < 0) {
      jf_pos = ld3(L + L_RJPOS);
      jf_rot = ld4(L + L_RJROT);
    } else {
      V3 a_pos = w.xpos[par] + rotate(ld3(L + L_TPOS), w.xrot[par]);
      Q4 a_rot = qmul(w.xrot[par], ld4(L + L_TROT));
      jf_pos = a_pos + rotate(ld3(L + L_JPOS), a_rot);
      jf_rot = qmul(a_rot, ld4(L + L_JROT));
    }
    int d0 = S.qd_off[l], qo = S.q_off[l];
    if (S.ltype[l] == 0) {
      for (int i = 0; i < 6; ++i) {
        const float* D = T + T_DOF + (d0 + i) * DOF_SIZE;
        V3 ang = rotate(ld3(D + D_ANG), jf_rot);
        w.cdof_a[d0 + i] = ang;
        w.cdof_v[d0 + i] = ld3(D + D_VEL) - cross(com - jf_pos, ang);
      }
      continue;
    }
    V3 acc_pos = {0.0f, 0.0f, 0.0f};
    Q4 acc_rot = {1.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < S.ltype[l]; ++i) {
      int dd = d0 + i;
      const float* D = T + T_DOF + dd * DOF_SIZE;
      V3 m_ang = ld3(D + D_ANG), m_vel = ld3(D + D_VEL);
      V3 ang_loc = m_ang, vel_loc = m_vel;
      if (i > 0) {
        ang_loc = rotate(m_ang, acc_rot);
        vel_loc = rotate(m_vel + cross(acc_pos, m_ang), acc_rot);
      }
      V3 ang = rotate(ang_loc, jf_rot);
      w.cdof_a[dd] = ang;
      w.cdof_v[dd] = vel_loc - cross(com - jf_pos, ang);
      if (i + 1 < S.ltype[l]) {
        float qi = w.q[qo + i];
        Q4 rot_i = normalize(quat_rot_axis(m_ang, qi));
        V3 pos_i = m_vel * qi;
        if (i == 0) {
          acc_pos = pos_i;
          acc_rot = rot_i;
        } else {
          acc_pos = acc_pos + rotate(pos_i, acc_rot);
          acc_rot = qmul(acc_rot, rot_i);
        }
      }
    }
  }
  __syncwarp();

  for (int d = lane; d < ND; d += 32) {
    s.cq_a[d] = w.cdof_a[d] * w.qd[d];
    s.cq_v[d] = w.cdof_v[d] * w.qd[d];
  }
  __syncwarp();
  for (int l = lane; l < NL; l += 32) {
    V3 zero = {0.0f, 0.0f, 0.0f};
    w.cd_a[l] = masked_sum<ND>(S.anc[l], zero, [&](int d) { return s.cq_a[d]; });
    w.cd_v[l] = masked_sum<ND>(S.anc[l], zero, [&](int d) { return s.cq_v[d]; });
  }
  __syncwarp();

  for (int l = lane; l < NL; l += 32) {
    int d0 = S.qd_off[l];
    if (S.ltype[l] == 0) {
      V3 lin_a = (s.cq_a[d0] + s.cq_a[d0 + 1]) + s.cq_a[d0 + 2];
      V3 lin_v = (s.cq_v[d0] + s.cq_v[d0 + 1]) + s.cq_v[d0 + 2];
      for (int k = 0; k < 6; ++k) {
        int d = d0 + k;
        if (k < 3) {
          w.cdofd_a[d] = w.cdofd_v[d] = V3{0.0f, 0.0f, 0.0f};
        } else {
          w.cdofd_a[d] = cross(lin_a, w.cdof_a[d]);
          w.cdofd_v[d] = cross(lin_a, w.cdof_v[d]) + cross(lin_v, w.cdof_a[d]);
        }
      }
      continue;
    }
    int par = S.com_parent[l];
    V3 pa = {0.0f, 0.0f, 0.0f}, pv = {0.0f, 0.0f, 0.0f};
    if (par >= 0) {
      pa = w.cd_a[par];
      pv = w.cd_v[par];
    }
    for (int i = 0; i < S.ltype[l]; ++i) {
      int d = d0 + i;
      w.cdofd_a[d] = cross(pa, w.cdof_a[d]);
      w.cdofd_v[d] = cross(pa, w.cdof_v[d]) + cross(pv, w.cdof_a[d]);
      if (i + 1 < S.ltype[l]) {
        pa = pa + s.cq_a[d];
        pv = pv + s.cq_v[d];
      }
    }
  }
  __syncwarp();
}

__device__ __forceinline__ V3 mv3(const M3& i, V3 v) {
  return {i.m[0][0] * v.x + i.m[0][1] * v.y + i.m[0][2] * v.z,
          i.m[1][0] * v.x + i.m[1][1] * v.y + i.m[1][2] * v.z,
          i.m[2][0] * v.x + i.m[2][1] * v.y + i.m[2][2] * v.z};
}

__device__ __forceinline__ void inertia_mul(const M3& i, V3 h, float mass, V3 m_ang, V3 m_vel,
                                            V3& f_ang, V3& f_vel) {
  f_ang = mv3(i, m_ang) + cross(h, m_vel);
  f_vel = m_vel * mass - cross(h, m_ang);
}

// -- mass matrix and its inverse ----------------------------------------------------

__device__ void mass_matrix(const float* T, const Scene& S, Work& w, int lane) {
  auto& s = w.u.mm;
  // crb: subtree sums of the CoM-frame inertias, per link
  for (int l = lane; l < NL; l += 32) {
    s.crb_i[l] = masked_sum<NL>(S.sub[l], M3{}, [&](int k) { return w.cinr_i[k]; });
    s.crb_h[l] = masked_sum<NL>(S.sub[l], V3{0.0f, 0.0f, 0.0f}, [&](int k) { return w.cinr_h[k]; });
  }
  __syncwarp();
  for (int d = lane; d < ND; d += 32) {
    int l = S.dof_link[d];
    inertia_mul(s.crb_i[l], s.crb_h[l], T[T_LINK + l * LINK_SIZE + L_CRBM], w.cdof_a[d],
                w.cdof_v[d], s.f_a[d], s.f_v[d]);
  }
  __syncwarp();
  // entry (r, c) from the lower triangle's (max, min), so that the two agree
  per_lane<ND * ND>(lane, [&](int p, bool own) {
    int r = p / ND, c = p - (p / ND) * ND;
    int i = r > c ? r : c, j = r > c ? c : r;
    float v = dot3(s.f_a[i], w.cdof_a[j]) + dot3(s.f_v[i], w.cdof_v[j]);
    v = bit(S.pair[i], j) ? v : 0.0f;
    if (i == j) v = v + T[T_DOF + i * DOF_SIZE + D_ARM];
    if (own) w.mx[p] = v;
  });
  __syncwarp();
}

// Newton-Schulz M^-1 warm-started from the carried inverse (replaced by the
// result)
__device__ void inv_ns(Work& w, int lane) {
  float* cur = w.minv;
  const float* mx = w.mx;
  auto& s = w.u.ns;
  // The warm start's upper triangle, mirrored.  2X - X M X keeps a symmetric
  // X symmetric but doubles any antisymmetric part at every iteration (16x a
  // frame), and the inverse pipeline.init hands in is symmetric only to
  // rounding: unmirrored, that part grew to 1e-1 within 5 frames of a
  // halfcheetah reset and the refresh fell back and diverged.
  per_lane<ND * ND>(lane, [&](int p, bool own) {
    int i = p / ND, j = p - (p / ND) * ND;
    if (own && i > j) cur[p] = cur[j * ND + i];
  });
  __syncwarp();
  matmul<false>(mx, cur, s.t1, lane);
  __syncwarp();
  per_lane<ND * ND>(lane, [&](int p, bool own) {
    float t = s.t1[p], m = mx[p];
    if (own) {
      s.p1[p] = t * t;
      s.p2[p] = m * m;
    }
  });
  for (int i = lane; i < ND; i += 32) s.p3[i] = s.t1[i * ND + i];
  __syncwarp();
  // trace, |M^-1 M|^2 and |M|^2, each on its own lane
  float sum = 0.0f;
  if (lane == 0)
    sum = lane_sum<ND>(s.p3);
  else if (lane < 3)
    sum = lane_sum<ND * ND>(lane == 1 ? s.p1 : s.p2);
  float tr_p0 = __shfl_sync(FULL, sum, 0), ss = __shfl_sync(FULL, sum, 1),
        tr = __shfl_sync(FULL, sum, 2);
  float r0 = ss - 2.0f * tr_p0 + (float)ND;
  float r0n = sqrtf(r0 > 0.0f ? r0 : 0.0f);
  bool fallback = r0n > 1.0f;
  if (fallback) {
    per_lane<ND * ND>(lane, [&](int p, bool own) {
      if (own) cur[p] = 0.5f * mx[p] / tr;
    });
    __syncwarp();
  }
  // Once err <= 1e-12 an iteration keeps cur as it is: the loop stops there.
  // The last iteration's err is read by nothing.  Without the fallback the
  // first iteration's M cur is the product above, already in t1.
  float err = 1.0f;
  for (int it = 0; it < GS_NS_ITERS && err > 1e-12f; ++it) {
    if (it > 0 || fallback) {
      matmul<false>(mx, cur, s.t1, lane);
      __syncwarp();
    }
    matmul<true>(cur, s.t1, s.t2, lane);
    __syncwarp();
    per_lane<ND * ND>(lane, [&](int p, bool own) {
      if (own) {
        float nxt = 2.0f * cur[p] - s.t2[p];
        float dd = nxt - cur[p];
        s.p1[p] = dd * dd;
        cur[p] = nxt;
      }
    });
    __syncwarp();
    if (it + 1 < GS_NS_ITERS) {
      float e2 = lane == 0 ? lane_sum<ND * ND>(s.p1) : 0.0f;
      err = sqrtf(__shfl_sync(FULL, e2, 0));
    }
  }
}

// -- forces --------------------------------------------------------------------------

// qf: passive and motor forces minus the RNE bias force
__device__ void bias_forces(const float* T, const Scene& S, Work& w, int lane) {
  auto& s = w.u.rne;
  V3 grav = ld3(T + T_GRAV);
  for (int l = lane; l < NL; l += 32) {
    V3 zero = {0.0f, 0.0f, 0.0f};
    V3 cdd_a = masked_sum<ND>(S.anc[l], zero, [&](int d) { return w.cdofd_a[d] * w.qd[d]; });
    V3 cdd_v = masked_sum<ND>(S.anc[l], zero, [&](int d) { return w.cdofd_v[d] * w.qd[d]; });
    cdd_v = cdd_v - grav;
    float m = T[T_LINK + l * LINK_SIZE + L_MASS];
    V3 fa, fv, ia, iv;
    inertia_mul(w.cinr_i[l], w.cinr_h[l], m, cdd_a, cdd_v, fa, fv);
    inertia_mul(w.cinr_i[l], w.cinr_h[l], m, w.cd_a[l], w.cd_v[l], ia, iv);
    s.cfrc_a[l] = (fa + cross(w.cd_a[l], ia)) + cross(w.cd_v[l], iv);
    s.cfrc_v[l] = fv + cross(w.cd_a[l], iv);
  }
  __syncwarp();
  for (int d = lane; d < ND; d += 32) {
    int l = S.dof_link[d];
    V3 zero = {0.0f, 0.0f, 0.0f};
    V3 sa = masked_sum<NL>(S.sub[l], zero, [&](int k) { return s.cfrc_a[k]; });
    V3 sv = masked_sum<NL>(S.sub[l], zero, [&](int k) { return s.cfrc_v[k]; });
    float bias = dot3(w.cdof_v[d], sv) + dot3(w.cdof_a[d], sa);
    const float* D = T + T_DOF + d * DOF_SIZE;
    float passive = -D[D_DAMP] * w.qd[d];
    if (S.has_stiff[d]) passive = passive - w.q[S.q_off[l] + (d - S.qd_off[l])] * D[D_STIFF];
    float tau = 0.0f;
    for (int k = 0; k < NA; ++k) {
      if (ACT_DOF[k] != d) continue;
      const float* A = T + T_ACT + k * ACT_SIZE;
      float force = fminf(fmaxf(w.act[k], A[1]), A[2]);
      tau = tau + A[0] * force;
    }
    w.qf[d] = passive - bias + tau;
  }
  __syncwarp();
}

__device__ __forceinline__ void imp_aref(float pos, float vel, float& imp, float& aref) {
  float x = fabsf(pos) / 0.001f;
  float a = 2.0f * (x * x);
  float b = 1.0f - 2.0f * ((1.0f - x) * (1.0f - x));
  float v = 0.9f + (x < 0.5f ? a : b) * GS_IMP_SPAN;
  v = fminf(fmaxf(v, 0.9f), 0.95f);
  imp = x > 1.0f ? 0.95f : v;
  aref = (-GS_IMP_B) * vel - GS_IMP_K * imp * pos;
}

// min 0.5 |A x + b|^2, x >= 0: FISTA, backtracking over 5 halvings.  A is
// symmetric bit for bit (its upper triangle, mirrored), so a lane reads row
// i of A as column i, next to its neighbours' columns.
__device__ void fista(Work& w, int lane) {
  auto& s = w.u.con;
  const float* A = s.amat;
  // eta: the largest absolute row sum; fmaxf picks the same value in any order
  float emax = __int_as_float(0x7fffffff);  // NaN: fmaxf's identity
  for (int i = lane; i < NR; i += 32) {
    float v = fabsf(A[i]);
    for (int j = 1; j < NR; ++j) v = v + fabsf(A[j * NR + i]);
    emax = fmaxf(emax, v);
  }
  for (int o = 16; o > 0; o >>= 1) emax = fmaxf(emax, __shfl_xor_sync(FULL, emax, o));
  float eta = 1.0f / (emax + 1e-10f);
  float t = 1.0f;
  for (int i = lane; i < NR; i += 32) s.x[i] = s.y[i] = 0.0f;
  __syncwarp();
  for (int it = 0; it < GS_ITERS; ++it) {
    for (int i = lane; i < NR; i += 32) {
      float v = A[i] * s.y[0];
      for (int k = 1; k < NR; ++k) v = v + A[k * NR + i] * s.y[k];
      v = v + s.b[i];
      s.r[i] = v;
      s.p1[i] = v * v;
    }
    __syncwarp();
    float f_y = 0.5f * __shfl_sync(FULL, lane == 0 ? lane_sum<NR>(s.p1) : 0.0f, 0);
    for (int j = lane; j < NR; j += 32) {
      float v = A[j] * s.r[0];
      for (int i = 1; i < NR; ++i) v = v + A[i * NR + j] * s.r[i];
      s.g[j] = v;
    }
    __syncwarp();
    float scale = 1.0f, eta_next = 0.0f;
    bool found = false;
    for (int k = 0; k < 5 && !found; ++k) {
      float e = eta * scale;
      scale = scale * 0.5f;
      float* c = k == 0 ? s.cand0 : s.cand;
      for (int i = lane; i < NR; i += 32) c[i] = fmaxf(s.y[i] - e * s.g[i], 0.0f);
      __syncwarp();
      for (int i = lane; i < NR; i += 32) {
        float ri = A[i] * c[0];
        for (int j = 1; j < NR; ++j) ri = ri + A[j * NR + i] * c[j];
        ri = ri + s.b[i];
        float di = c[i] - s.y[i];
        s.p1[i] = ri * ri;
        s.p2[i] = di * s.g[i];
        s.p3[i] = di * di;
      }
      __syncwarp();
      // |A c + b|^2, (c - y).g and |c - y|^2, each on its own lane
      float sum = lane < 3 ? lane_sum<NR>(lane == 0 ? s.p1 : lane == 1 ? s.p2 : s.p3) : 0.0f;
      float fc = __shfl_sync(FULL, sum, 0), dg = __shfl_sync(FULL, sum, 1),
            dd = __shfl_sync(FULL, sum, 2);
      float bound = f_y + dg + (0.5f / e) * dd;
      if (0.5f * fc <= bound + 1e-12f) {
        found = true;
        eta_next = e;
        if (k > 0)
          for (int i = lane; i < NR; i += 32) s.cand0[i] = s.cand[i];
      } else if (k == 4) {
        eta_next = e * 0.5f;
      }
      __syncwarp();
    }
    float t_next = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * t * t));
    float mom = (t - 1.0f) / t_next;
    for (int i = lane; i < NR; i += 32) {
      s.y[i] = s.cand0[i] + mom * (s.cand0[i] - s.x[i]);
      s.x[i] = s.cand0[i];
    }
    __syncwarp();
    t = t_next;
    eta = eta_next * 1.5f;
  }
}

// qfc: the contact and limit forces J^T x
__device__ void constraint_forces(const float* T, const Scene& S, Work& w, int lane) {
  if (NR == 0) {
    for (int d = lane; d < ND; d += 32) w.qfc[d] = 0.0f;
    __syncwarp();
    return;
  }
  auto& s = w.u.con;
  per_lane<NR * ND>(lane, [&](int p, bool own) {
    if (own) s.jac[p] = 0.0f;
  });
  __syncwarp();
  for (int p = lane; p < NC * ND; p += 32) {
    int c = p / ND, d = p - (p / ND) * ND;
    if (!bit(S.anc[S.c_link[c]], d)) continue;
    const float* C = T + T_CON + c * CONTACT_SIZE;
    float active = w.cpen[c] > 0.0f ? 1.0f : 0.0f;
    V3 off = w.cpos[c] - w.com;
    V3 av = w.cdof_v[d] - cross(off, w.cdof_a[d]);
    for (int r = 0; r < 4; ++r) {
      const float* dir = C + C_DIRS + 3 * r;
      s.jac[(4 * c + r) * ND + d] = (dir[0] * av.x + dir[1] * av.y + dir[2] * av.z) * active;
    }
  }
  for (int r = lane; r < 4 * NC; r += 32) {
    int c = r / 4;
    float active = w.cpen[c] > 0.0f ? 1.0f : 0.0f;
    s.pos_r[r] = (-w.cpen[c]) * active;
    s.diag_r[r] = T[T_CON + c * CONTACT_SIZE + C_DIAG] * active;
  }
  for (int i = lane; i < NLIM; i += 32) {
    int d = S.lim_d[i], row = 4 * NC + i;
    const float* D = T + T_DOF + d * DOF_SIZE;
    float qi = w.q[S.lim_q[i]];
    float pos_min = qi - D[D_LO], pos_max = D[D_HI] - qi;
    float pos = fminf(fminf(pos_min, pos_max), 0.0f);
    float closed = pos < 0.0f ? 1.0f : 0.0f;
    s.jac[row * ND + d] = ((pos_min < pos_max ? 1.0f : 0.0f) * 2.0f - 1.0f) * closed;
    s.pos_r[row] = pos;
    s.diag_r[row] = D[D_IW] * closed;
  }
  __syncwarp();

  // J M^-1 over each row's support, J qd, the impedance and the diagonal
  per_lane<NR * ND>(lane, [&](int p, bool own) {
    int i = p / ND, e = p - (p / ND) * ND;
    const float* ji = s.jac + i * ND;
    float v = masked_sum<ND>(S.row[i], 0.0f, [&](int d) { return ji[d] * w.minv[d * ND + e]; });
    if (own) s.jm[p] = v;
  });
  for (int i = lane; i < NR; i += 32) {
    const float* ji = s.jac + i * ND;
    float jqd = masked_sum<ND>(S.row[i], 0.0f, [&](int d) { return ji[d] * w.qd[d]; });
    float imp, aref;
    imp_aref(s.pos_r[i], jqd, imp, aref);
    s.diag_add[i] = s.diag_r[i] * (1.0f - imp) / imp;
    s.aref[i] = aref;
  }
  __syncwarp();
  for (int i = lane; i < NR; i += 32) {
    const float* jmi = s.jm + i * ND;
    float v = jmi[0] * w.qf[0];
    for (int k = 1; k < ND; ++k) v = v + jmi[k] * w.qf[k];
    s.b[i] = v - s.aref[i];
  }
  // A's upper triangle, each entry contracted over the sparser row's support
  int i = 0, j = 0;
  upper_next(i, j, lane, NR);
#pragma unroll
  for (int r = 0; r < (NR * (NR + 1) / 2 + 31) / 32; ++r) {
    bool own = i < NR;
    int ri = own ? i : NR - 1, rj = own ? j : NR - 1;
    int a = ri, b = rj;
    if (!(__popcll(S.row[rj]) <= __popcll(S.row[ri]))) {
      a = rj;
      b = ri;
    }
    float v = masked_sum<ND>(S.row[b], 0.0f, [&](int d) { return s.jac[b * ND + d] * s.jm[a * ND + d]; });
    if (ri == rj) v = v + s.diag_add[ri];
    if (own) {
      s.amat[ri * NR + rj] = v;
      s.amat[rj * NR + ri] = v;
    }
    upper_next(i, j, 32, NR);
  }
  __syncwarp();
  fista(w, lane);
  for (int d = lane; d < ND; d += 32) {
    float v = 0.0f;
    bool first = true;
#pragma unroll
    for (int r = 0; r < NR; ++r) {  // the rows that touch dof d
      if (!bit(S.row[r], d)) continue;
      float t = s.jac[r * ND + d] * s.x[r];
      v = first ? t : v + t;
      first = false;
    }
    w.qfc[d] = v;
  }
  __syncwarp();
}

// damping folded into M^-1: qdd = (M^-1 - M^-1 diag(damping dt) M^-1) qf,
// then semi-implicit Euler
__device__ void integrate(const float* T, const Scene& S, Work& w, int lane) {
  auto& s = w.u.ns;
  const float* minv = w.minv;
  per_lane<ND * ND>(lane, [&](int p, bool own) {
    int k = p - (p / ND) * ND;
    if (own) s.t1[p] = minv[p] * T[T_DOF + k * DOF_SIZE + D_DCOL];
  });
  __syncwarp();
  matmul<true>(s.t1, minv, s.t2, lane);
  __syncwarp();
  float dt = T[T_DT];
  // row i of the symmetric M^-1 and t2 read as column i
  for (int i = lane; i < ND; i += 32) {
    float v = 0.0f;
    for (int k = 0; k < ND; ++k) {
      float t = (minv[k * ND + i] - s.t2[k * ND + i]) * (w.qf[k] + w.qfc[k]);
      v = k == 0 ? t : v + t;
    }
    w.qd[i] = w.qd[i] + v * dt;
  }
  __syncwarp();
  float* q = w.q;
  const float* qd = w.qd;
  for (int l = lane; l < NL; l += 32) {
    int qo = S.q_off[l], d0 = S.qd_off[l];
    if (S.ltype[l] != 0) {
      for (int i = 0; i < S.ltype[l]; ++i) q[qo + i] = q[qo + i] + qd[d0 + i] * dt;
      continue;
    }
    V3 ang = {qd[d0 + 3], qd[d0 + 4], qd[d0 + 5]};
    float ang_norm = sqrtf(dot3(ang, ang)) + 1e-8f;
    V3 axis = {ang.x / ang_norm, ang.y / ang_norm, ang.z / ang_norm};
    Q4 rot = qmul(Q4{q[qo + 3], q[qo + 4], q[qo + 5], q[qo + 6]},
                  quat_rot_axis(axis, dt * ang_norm));
    float rn = sqrtf(sumsq4(rot));
    for (int i = 0; i < 3; ++i) q[qo + i] = q[qo + i] + qd[d0 + i] * dt;
    q[qo + 3] = rot.w / rn;
    q[qo + 4] = rot.x / rn;
    q[qo + 5] = rot.y / rn;
    q[qo + 6] = rot.z / rn;
  }
  __syncwarp();
}

__device__ void frame(const float* T, const Scene& S, Work& w, int lane) {
  fk(T, S, w.q, w.xpos, w.xrot, lane);
  contacts(T, S, w.xpos, w.xrot, w.cpos, w.cpen, lane);
  transform_com(T, S, w, lane);
  mass_matrix(T, S, w, lane);
  inv_ns(w, lane);
  bias_forces(T, S, w, lane);
  constraint_forces(T, S, w, lane);
  integrate(T, S, w, lane);
}

// -- the block: staging, loads and stores ---------------------------------------

__device__ void build_scene(Scene& S) {
  for (int l = threadIdx.x; l < NL; l += blockDim.x) {
    unsigned long long anc = 0, sub = 0;
    for (int d = 0; d < ND; ++d) anc |= (unsigned long long)(DOF_ANC[l][d] != 0) << d;
    for (int k = 0; k < NL; ++k) sub |= (unsigned long long)(SUB_LINK[l][k] != 0) << k;
    S.anc[l] = anc;
    S.sub[l] = sub;
    S.ltype[l] = LTYPE[l];
    S.parent[l] = PARENT[l];
    S.com_parent[l] = COM_PARENT[l];
    S.q_off[l] = Q_OFF[l];
    S.qd_off[l] = QD_OFF[l];
    S.depth[l] = LDEPTH[l];
  }
  for (int i = threadIdx.x; i < ND; i += blockDim.x) {
    unsigned long long pair = 0;
    for (int j = 0; j <= i; ++j) pair |= (unsigned long long)(DOF_PAIR[i][j] != 0) << j;
    S.pair[i] = pair;
    S.dof_link[i] = DOF_LINK[i];
    S.has_stiff[i] = HAS_STIFF[i];
  }
  for (int r = threadIdx.x; r < NR; r += blockDim.x) {
    // a contact link's ancestor chain, or one limited dof
    unsigned long long row = 0;
    for (int d = 0; d < ND; ++d)
      row |= (unsigned long long)(r < 4 * NC ? DOF_ANC[C_LINK[r / 4]][d] != 0 : LIM_D[r - 4 * NC] == d) << d;
    S.row[r] = row;
  }
  for (int c = threadIdx.x; c < NC; c += blockDim.x) S.c_link[c] = C_LINK[c];
  for (int i = threadIdx.x; i < NLIM; i += blockDim.x) {
    S.lim_q[i] = LIM_Q[i];
    S.lim_d[i] = LIM_D[i];
  }
}

// The block's envs' fields f < nf, between the (field, env) layout of global
// memory and the field at byte `off` of each env's Work; neighbouring
// threads take neighbouring envs.
__device__ void load(const float* __restrict__ src, Work* W, size_t off, int nf, int n, int e0,
                     int ne) {
  for (int i = threadIdx.x; i < nf * ne; i += blockDim.x) {
    int f = i / ne, k = i - (i / ne) * ne;
    reinterpret_cast<float*>(reinterpret_cast<char*>(W + k) + off)[f] = src[(size_t)f * n + e0 + k];
  }
}

__device__ void store(float* __restrict__ dst, const Work* W, size_t off, int nf, int n, int e0,
                      int ne) {
  for (int i = threadIdx.x; i < nf * ne; i += blockDim.x) {
    int f = i / ne, k = i - (i / ne) * ne;
    dst[(size_t)f * n + e0 + k] =
        reinterpret_cast<const float*>(reinterpret_cast<const char*>(W + k) + off)[f];
  }
}

#define OFF(member) ((size_t)(reinterpret_cast<const char*>(&W->member) - reinterpret_cast<const char*>(W)))

__global__ void __launch_bounds__(32 * MAX_ENVS_PER_BLOCK)
    gen_step_kernel(const float* __restrict__ q_in, const float* __restrict__ qd_in,
                    const float* __restrict__ minv_in, const float* __restrict__ act_in,
                    float* __restrict__ q_out, float* __restrict__ qd_out,
                    float* __restrict__ minv_out, float* __restrict__ x_pos,
                    float* __restrict__ x_rot, float* __restrict__ xd_ang,
                    float* __restrict__ xd_vel, float* __restrict__ c_pos,
                    float* __restrict__ c_pen, const float* __restrict__ table, int n,
                    int n_frames) {
  extern __shared__ float4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  float* T = reinterpret_cast<float*>(base);
  Scene& S = *reinterpret_cast<Scene*>(base + T_BYTES);
  Work* W = reinterpret_cast<Work*>(base + FIXED_BYTES);
  const int per_block = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e0 = blockIdx.x * per_block;
  const int ne = min(per_block, n - e0);

  for (int i = threadIdx.x; i < T_SIZE; i += blockDim.x) T[i] = table[i];
  build_scene(S);
  load(q_in, W, OFF(q), NQ, n, e0, ne);
  load(qd_in, W, OFF(qd), ND, n, e0, ne);
  load(minv_in, W, OFF(minv), ND * ND, n, e0, ne);
  load(act_in, W, OFF(act), NA, n, e0, ne);
  __syncthreads();

  if (warp < ne) {
    Work& w = W[warp];
    for (int f = 0; f < n_frames; ++f) frame(T, S, w, lane);
    fk(T, S, w.q, w.xpos, w.xrot, lane);
    fk_vel(T, S, w.q, w.qd, w.xpos, w.xrot, w.u.fin.xd_ang, w.u.fin.xd_vel, lane);
    contacts(T, S, w.xpos, w.xrot, w.cpos, w.cpen, lane);
  }
  __syncthreads();

  store(q_out, W, OFF(q), NQ, n, e0, ne);
  store(qd_out, W, OFF(qd), ND, n, e0, ne);
  store(minv_out, W, OFF(minv), ND * ND, n, e0, ne);
  store(x_pos, W, OFF(xpos), 3 * NL, n, e0, ne);
  store(x_rot, W, OFF(xrot), 4 * NL, n, e0, ne);
  store(xd_ang, W, OFF(u.fin.xd_ang), 3 * NL, n, e0, ne);
  store(xd_vel, W, OFF(u.fin.xd_vel), 3 * NL, n, e0, ne);
  store(c_pos, W, OFF(cpos), 3 * NC, n, e0, ne);
  store(c_pen, W, OFF(cpen), NC, n, e0, ne);
}

}  // namespace

extern "C" int brax_gen_step_sizes(int* out) {
  out[0] = NL;
  out[1] = NQ;
  out[2] = ND;
  out[3] = NC;
  out[4] = NA;
  out[5] = NR;
  out[6] = (int)sizeof(Work);
  out[7] = FIXED_BYTES;
  out[8] = MAX_ENVS_PER_BLOCK;
  return 0;
}

// Lets the kernel take up to MAX_SMEM bytes of shared memory on the current
// device, and reports its registers per thread and local (stack) bytes per
// thread in attrs[0:2].  Called once per loaded library and device.
extern "C" int brax_gen_step_init(int* attrs) {
  cudaError_t err = cudaFuncSetAttribute(gen_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gen_step_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, gen_step_kernel);
  if (err == cudaSuccess) {
    attrs[0] = a.numRegs;
    attrs[1] = (int)a.localSizeBytes;
  }
  return (int)err;
}

// Blocks resident per SM at envs_per_block warps each, by the runtime's
// occupancy calculator; brax_gen_step_init must have run on the device.
extern "C" int brax_gen_step_occupancy(int envs_per_block, int* blocks) {
  size_t smem = FIXED_BYTES + (size_t)envs_per_block * sizeof(Work);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gen_step_kernel,
                                                            32 * envs_per_block, smem);
}

// One launch: ceil(n / envs_per_block) blocks of envs_per_block warps, one
// env each; brax_gen_step_init must have run on the current device.
extern "C" int brax_gen_step(const float* q, const float* qd, const float* minv, const float* act,
                             float* q_out, float* qd_out, float* minv_out, float* x_pos,
                             float* x_rot, float* xd_ang, float* xd_vel, float* c_pos,
                             float* c_pen, const float* table, int n, int n_frames,
                             int envs_per_block, void* stream) {
  if (n <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > MAX_ENVS_PER_BLOCK ||
      FIXED_BYTES + envs_per_block * (int)sizeof(Work) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  int grid = (n + envs_per_block - 1) / envs_per_block;
  size_t smem = FIXED_BYTES + (size_t)envs_per_block * sizeof(Work);
  gen_step_kernel<<<grid, 32 * envs_per_block, smem, (cudaStream_t)stream>>>(
      q, qd, minv, act, q_out, qd_out, minv_out, x_pos, x_rot, xd_ang, xd_vel, c_pos, c_pen, table,
      n, n_frames);
  return (int)cudaGetLastError();
}
