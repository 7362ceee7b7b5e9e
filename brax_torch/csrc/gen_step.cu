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
// Layout: one thread per env; every input and output is SoA (field, env),
// so neighbouring threads touch neighbouring addresses.  The sizes and the
// tree structure are compile-time constants, from the header that
// kernels.py::scene_header writes in front of this file; the scene's float
// constants come from a table (kernels.py::pack_tables), staged into shared
// memory per block.
//
// What bounds it: operations, and the latency of one long serial chain per
// env.  The per-env working set (M, M^-1, the Newton-Schulz temporaries,
// J, J M^-1, A: about 2k floats for ant) lives in local memory (L1/L2).
// This first version keeps that simple; the plain-torch version in
// kernels.py repeats its arithmetic in the same order, and the source is
// compiled without FMA contraction so that the two round alike.

#include <cuda_runtime.h>

#ifndef GS_NL
#error "gen_step.cu is compiled through brax_torch/v2/generalized/kernels.py::kernel_source"
#endif

namespace {

constexpr int NL = GS_NL, NQ = GS_NQ, ND = GS_ND, NC = GS_NC, NA = GS_NA, NR = GS_NR;
constexpr int NLIM = GS_NLIM;
constexpr int NC1 = NC > 0 ? NC : 1, NA1 = NA > 0 ? NA : 1, NR1 = NR > 0 ? NR : 1;

// float table (kernels.py::pack_tables)
constexpr int LINK_SIZE = 39, DOF_SIZE = 13, ACT_SIZE = 3, CONTACT_SIZE = 23;
constexpr int T_DT = 0, T_GRAV = 1, T_TOTM = 4;
constexpr int T_LINK = 5;
constexpr int T_DOF = T_LINK + NL * LINK_SIZE;
constexpr int T_ACT = T_DOF + ND * DOF_SIZE;
constexpr int T_CON = T_ACT + NA * ACT_SIZE;
constexpr int T_SIZE = T_CON + NC * CONTACT_SIZE;
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

__device__ __forceinline__ V3 ld3(const float* t) { return {t[0], t[1], t[2]}; }
__device__ __forceinline__ Q4 ld4(const float* t) { return {t[0], t[1], t[2], t[3]}; }

__device__ __forceinline__ bool in_row(int r, int d) {
  // the dofs constraint row r touches: a contact link's ancestor chain, or
  // one limited dof
  if (r < 4 * NC) return DOF_ANC[C_LINK[r / 4]][d] != 0;
  return LIM_D[r - 4 * NC] == d;
}

// -- kinematics --------------------------------------------------------------

__device__ void fk(const float* T, const float* q, V3* xpos, Q4* xrot) {
  for (int l = 0; l < NL; ++l) {
    const float* L = T + T_LINK + l * LINK_SIZE;
    int qo = Q_OFF[l];
    V3 jp;
    Q4 jr;
    if (LTYPE[l] == 0) {
      jp = {q[qo], q[qo + 1], q[qo + 2]};
      jr = {q[qo + 3], q[qo + 4], q[qo + 5], q[qo + 6]};
    } else {
      int d0 = QD_OFF[l];
      for (int i = 0; i < LTYPE[l]; ++i) {
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
    jp = ld3(L + L_TPOS) + rotate(jp, trot);
    jr = qmul(trot, jr);
    int par = PARENT[l];
    if (par < 0) {
      xpos[l] = jp;
      xrot[l] = jr;
    } else {
      xpos[l] = xpos[par] + rotate(jp, xrot[par]);
      xrot[l] = qmul(xrot[par], jr);
    }
  }
  for (int l = 0; l < NL; ++l) xrot[l] = normalize(xrot[l]);
}

__device__ void fk_vel(const float* T, const float* q, const float* qd, const V3* xpos,
                       const Q4* xrot, V3* xd_ang, V3* xd_vel) {
  for (int l = 0; l < NL; ++l) {
    int d0 = QD_OFF[l], qo = Q_OFF[l];
    V3 ja, jv;
    if (LTYPE[l] == 0) {
      ja = {qd[d0 + 3], qd[d0 + 4], qd[d0 + 5]};
      jv = {qd[d0], qd[d0 + 1], qd[d0 + 2]};
    } else {
      const float* D = T + T_DOF + d0 * DOF_SIZE;
      ja = ld3(D + D_ANG) * qd[d0];
      jv = ld3(D + D_VEL) * qd[d0];
      for (int i = 1; i < LTYPE[l]; ++i) {
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
    int par = PARENT[l];
    if (par < 0) {
      xd_ang[l] = ja;
      xd_vel[l] = jv;
    } else {
      xd_ang[l] = xd_ang[par] + rotate(ja, xrot[l]);
      xd_vel[l] = xd_vel[par] + rotate(jv + cross(xpos[l], ja), xrot[l]);
    }
  }
}

__device__ void contacts(const float* T, const V3* xpos, const Q4* xrot, V3* cpos, float* cpen) {
  for (int c = 0; c < NC; ++c) {
    const float* C = T + T_CON + c * CONTACT_SIZE;
    int l = C_LINK[c];
    V3 n = ld3(C + C_NRM);
    float r = C[C_RAD];
    V3 spos = xpos[l] + rotate(ld3(C + C_LPOS), xrot[l]);
    float pen = r - dot3(spos - ld3(C + C_PPOS), n);
    cpos[c] = spos - n * (r - 0.5f * pen);
    cpen[c] = pen;
  }
}

// -- CoM-frame terms -----------------------------------------------------------

struct Com {
  V3 com;
  M3 cinr_i[NL];
  V3 cinr_h[NL];
  V3 cdof_a[ND], cdof_v[ND], cdofd_a[ND], cdofd_v[ND];
  V3 cd_a[NL], cd_v[NL];
};

__device__ void transform_com(const float* T, const float* q, const float* qd, const V3* xpos,
                              const Q4* xrot, Com& s) {
  V3 xi_pos[NL];
  Q4 xi_rot[NL];
  for (int l = 0; l < NL; ++l) {
    const float* L = T + T_LINK + l * LINK_SIZE;
    xi_pos[l] = xpos[l] + rotate(ld3(L + L_IPOS), xrot[l]);
    xi_rot[l] = qmul(xrot[l], ld4(L + L_IROT));
  }
  V3 com = xi_pos[0] * T[T_LINK + L_MASS];
  for (int l = 1; l < NL; ++l) com = com + xi_pos[l] * T[T_LINK + l * LINK_SIZE + L_MASS];
  float tot = T[T_TOTM];
  com = {com.x / tot, com.y / tot, com.z / tot};
  s.com = com;

  for (int l = 0; l < NL; ++l) {
    const float* L = T + T_LINK + l * LINK_SIZE;
    V3 pos = xi_pos[l] - com;
    Q4 qr = xi_rot[l];
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
        s.cinr_i[l].m[a][b] = (ri[a][0] * r[b][0] + ri[a][1] * r[b][1] + ri[a][2] * r[b][2]) +
                              dot3(h[a], h[b]) * m;
    s.cinr_h[l] = pos * m;
  }

  for (int l = 0; l < NL; ++l) {
    const float* L = T + T_LINK + l * LINK_SIZE;
    int par = COM_PARENT[l];
    V3 jf_pos;
    Q4 jf_rot;
    if (par < 0) {
      jf_pos = ld3(L + L_RJPOS);
      jf_rot = ld4(L + L_RJROT);
    } else {
      V3 a_pos = xpos[par] + rotate(ld3(L + L_TPOS), xrot[par]);
      Q4 a_rot = qmul(xrot[par], ld4(L + L_TROT));
      jf_pos = a_pos + rotate(ld3(L + L_JPOS), a_rot);
      jf_rot = qmul(a_rot, ld4(L + L_JROT));
    }
    int d0 = QD_OFF[l], qo = Q_OFF[l];
    if (LTYPE[l] == 0) {
      for (int i = 0; i < 6; ++i) {
        const float* D = T + T_DOF + (d0 + i) * DOF_SIZE;
        V3 ang = rotate(ld3(D + D_ANG), jf_rot);
        s.cdof_a[d0 + i] = ang;
        s.cdof_v[d0 + i] = ld3(D + D_VEL) - cross(com - jf_pos, ang);
      }
      continue;
    }
    V3 acc_pos = {0.0f, 0.0f, 0.0f};
    Q4 acc_rot = {1.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < LTYPE[l]; ++i) {
      int d = d0 + i;
      const float* D = T + T_DOF + d * DOF_SIZE;
      V3 m_ang = ld3(D + D_ANG), m_vel = ld3(D + D_VEL);
      V3 ang_loc = m_ang, vel_loc = m_vel;
      if (i > 0) {
        ang_loc = rotate(m_ang, acc_rot);
        vel_loc = rotate(m_vel + cross(acc_pos, m_ang), acc_rot);
      }
      V3 ang = rotate(ang_loc, jf_rot);
      s.cdof_a[d] = ang;
      s.cdof_v[d] = vel_loc - cross(com - jf_pos, ang);
      if (i + 1 < LTYPE[l]) {
        float qi = q[qo + i];
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

  V3 cq_a[ND], cq_v[ND];
  for (int d = 0; d < ND; ++d) {
    cq_a[d] = s.cdof_a[d] * qd[d];
    cq_v[d] = s.cdof_v[d] * qd[d];
  }
  for (int l = 0; l < NL; ++l) {
    bool first = true;
    for (int d = 0; d < ND; ++d) {
      if (!DOF_ANC[l][d]) continue;
      if (first) {
        s.cd_a[l] = cq_a[d];
        s.cd_v[l] = cq_v[d];
        first = false;
      } else {
        s.cd_a[l] = s.cd_a[l] + cq_a[d];
        s.cd_v[l] = s.cd_v[l] + cq_v[d];
      }
    }
  }

  for (int l = 0; l < NL; ++l) {
    int d0 = QD_OFF[l];
    if (LTYPE[l] == 0) {
      V3 lin_a = (cq_a[d0] + cq_a[d0 + 1]) + cq_a[d0 + 2];
      V3 lin_v = (cq_v[d0] + cq_v[d0 + 1]) + cq_v[d0 + 2];
      for (int k = 0; k < 6; ++k) {
        int d = d0 + k;
        if (k < 3) {
          s.cdofd_a[d] = s.cdofd_v[d] = V3{0.0f, 0.0f, 0.0f};
        } else {
          s.cdofd_a[d] = cross(lin_a, s.cdof_a[d]);
          s.cdofd_v[d] = cross(lin_a, s.cdof_v[d]) + cross(lin_v, s.cdof_a[d]);
        }
      }
      continue;
    }
    int par = COM_PARENT[l];
    V3 pa = {0.0f, 0.0f, 0.0f}, pv = {0.0f, 0.0f, 0.0f};
    if (par >= 0) {
      pa = s.cd_a[par];
      pv = s.cd_v[par];
    }
    for (int i = 0; i < LTYPE[l]; ++i) {
      int d = d0 + i;
      s.cdofd_a[d] = cross(pa, s.cdof_a[d]);
      s.cdofd_v[d] = cross(pa, s.cdof_v[d]) + cross(pv, s.cdof_a[d]);
      if (i + 1 < LTYPE[l]) {
        pa = pa + cq_a[d];
        pv = pv + cq_v[d];
      }
    }
  }
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

__device__ void mass_matrix(const float* T, const Com& s, float* mx) {
  // crb: subtree sums of the CoM-frame inertias, per link
  M3 crb_i[NL];
  V3 crb_h[NL];
  for (int l = 0; l < NL; ++l) {
    bool first = true;
    for (int k = 0; k < NL; ++k) {
      if (!SUB_LINK[l][k]) continue;
      if (first) {
        crb_i[l] = s.cinr_i[k];
        crb_h[l] = s.cinr_h[k];
        first = false;
      } else {
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) crb_i[l].m[a][b] = crb_i[l].m[a][b] + s.cinr_i[k].m[a][b];
        crb_h[l] = crb_h[l] + s.cinr_h[k];
      }
    }
  }
  V3 f_a[ND], f_v[ND];
  for (int d = 0; d < ND; ++d) {
    int l = DOF_LINK[d];
    inertia_mul(crb_i[l], crb_h[l], T[T_LINK + l * LINK_SIZE + L_CRBM], s.cdof_a[d], s.cdof_v[d],
                f_a[d], f_v[d]);
  }
  for (int i = 0; i < ND; ++i) {
    for (int j = 0; j <= i; ++j) {
      float v = DOF_PAIR[i][j] ? dot3(f_a[i], s.cdof_a[j]) + dot3(f_v[i], s.cdof_v[j]) : 0.0f;
      if (i == j) v = v + T[T_DOF + i * DOF_SIZE + D_ARM];
      mx[i * ND + j] = v;
      mx[j * ND + i] = v;
    }
  }
}

// c = a @ b over the full matrix (upper=false) or its upper triangle mirrored
__device__ void matmul(const float* a, const float* b, float* c, bool upper) {
  for (int i = 0; i < ND; ++i) {
    for (int j = upper ? i : 0; j < ND; ++j) {
      float v = a[i * ND] * b[j];
      for (int k = 1; k < ND; ++k) v = v + a[i * ND + k] * b[k * ND + j];
      c[i * ND + j] = v;
      if (upper) c[j * ND + i] = v;
    }
  }
}

__device__ float sum_all(const float* m) {
  float s = m[0];
  for (int i = 1; i < ND * ND; ++i) s = s + m[i];
  return s;
}

// Newton-Schulz M^-1 warm-started from cur (replaced by the result); t1, t2
// are ND*ND scratch.
__device__ void inv_ns(const float* mx, float* cur, float* t1, float* t2) {
  // The warm start's upper triangle, mirrored.  2X - X M X keeps a symmetric
  // X symmetric but doubles any antisymmetric part at every iteration (16x a
  // frame), and the inverse pipeline.init hands in is symmetric only to
  // rounding: unmirrored, that part grew to 1e-1 within 5 frames of a
  // halfcheetah reset and the refresh fell back and diverged.
  for (int i = 1; i < ND; ++i)
    for (int j = 0; j < i; ++j) cur[i * ND + j] = cur[j * ND + i];
  matmul(mx, cur, t1, false);
  float tr_p0 = t1[0];
  for (int i = 1; i < ND; ++i) tr_p0 = tr_p0 + t1[i * ND + i];
  float ss = t1[0] * t1[0];
  for (int i = 1; i < ND * ND; ++i) ss = ss + t1[i] * t1[i];
  float r0 = ss - 2.0f * tr_p0 + (float)ND;
  float r0n = sqrtf(r0 > 0.0f ? r0 : 0.0f);
  float tr = mx[0] * mx[0];
  for (int i = 1; i < ND * ND; ++i) tr = tr + mx[i] * mx[i];
  if (r0n > 1.0f)
    for (int i = 0; i < ND * ND; ++i) cur[i] = 0.5f * mx[i] / tr;
  float err = 1.0f;
  for (int it = 0; it < GS_NS_ITERS; ++it) {
    matmul(mx, cur, t1, false);
    matmul(cur, t1, t2, true);
    float e2 = 0.0f;
    for (int i = 0; i < ND * ND; ++i) {
      float nxt = 2.0f * cur[i] - t2[i];
      float dd = nxt - cur[i];
      e2 = i == 0 ? dd * dd : e2 + dd * dd;
      t2[i] = nxt;
    }
    if (err > 1e-12f) {
      for (int i = 0; i < ND * ND; ++i) cur[i] = t2[i];
      err = sqrtf(e2);
    }
  }
}

// -- constraints -------------------------------------------------------------------

__device__ __forceinline__ void imp_aref(float pos, float vel, float& imp, float& aref) {
  float x = fabsf(pos) / 0.001f;
  float a = 2.0f * (x * x);
  float b = 1.0f - 2.0f * ((1.0f - x) * (1.0f - x));
  float v = 0.9f + (x < 0.5f ? a : b) * GS_IMP_SPAN;
  v = fminf(fmaxf(v, 0.9f), 0.95f);
  imp = x > 1.0f ? 0.95f : v;
  aref = (-GS_IMP_B) * vel - GS_IMP_K * imp * pos;
}

__device__ __forceinline__ float rowdot(const float* a, const float* x, int n) {
  float v = a[0] * x[0];
  for (int k = 1; k < n; ++k) v = v + a[k] * x[k];
  return v;
}

__device__ __forceinline__ float sumsq(const float* a, int n) {
  float v = a[0] * a[0];
  for (int k = 1; k < n; ++k) v = v + a[k] * a[k];
  return v;
}

// min 0.5 |A x + b|^2, x >= 0: FISTA, backtracking over 5 halvings
__device__ void fista(const float* A, const float* b, float* x) {
  float y[NR1], g[NR1], r[NR1], cand[NR1], cand0[NR1];
  float eta = 0.0f;
  for (int i = 0; i < NR; ++i) {
    float s = fabsf(A[i * NR]);
    for (int j = 1; j < NR; ++j) s = s + fabsf(A[i * NR + j]);
    eta = i == 0 ? s : fmaxf(eta, s);
  }
  eta = 1.0f / (eta + 1e-10f);
  float t = 1.0f;
  for (int i = 0; i < NR; ++i) x[i] = y[i] = 0.0f;
  for (int it = 0; it < GS_ITERS; ++it) {
    for (int i = 0; i < NR; ++i) r[i] = rowdot(A + i * NR, y, NR) + b[i];
    float f_y = 0.5f * sumsq(r, NR);
    for (int j = 0; j < NR; ++j) {
      float v = A[j] * r[0];
      for (int i = 1; i < NR; ++i) v = v + A[i * NR + j] * r[i];
      g[j] = v;
    }
    float scale = 1.0f, eta_next = 0.0f;
    bool found = false;
    for (int k = 0; k < 5 && !found; ++k) {
      float e = eta * scale;
      scale = scale * 0.5f;
      float* c = k == 0 ? cand0 : cand;
      for (int i = 0; i < NR; ++i) c[i] = fmaxf(y[i] - e * g[i], 0.0f);
      float fc = 0.0f, dg = 0.0f, dd = 0.0f;
      for (int i = 0; i < NR; ++i) {
        float ri = rowdot(A + i * NR, c, NR) + b[i];
        float di = c[i] - y[i];
        fc = i == 0 ? ri * ri : fc + ri * ri;
        dg = i == 0 ? di * g[i] : dg + di * g[i];
        dd = i == 0 ? di * di : dd + di * di;
      }
      float bound = f_y + dg + (0.5f / e) * dd;
      if (0.5f * fc <= bound + 1e-12f) {
        found = true;
        eta_next = e;
        if (k > 0)
          for (int i = 0; i < NR; ++i) cand0[i] = cand[i];
      } else if (k == 4) {
        eta_next = e * 0.5f;
      }
    }
    float t_next = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * t * t));
    float mom = (t - 1.0f) / t_next;
    for (int i = 0; i < NR; ++i) {
      y[i] = cand0[i] + mom * (cand0[i] - x[i]);
      x[i] = cand0[i];
    }
    t = t_next;
    eta = eta_next * 1.5f;
  }
}

// -- one frame ------------------------------------------------------------------------

struct Work {
  float mx[ND * ND], t1[ND * ND], t2[ND * ND];
  float jac[NR1 * ND], jm[NR1 * ND], amat[NR1 * NR1];
  Com com;
};

__device__ void frame(const float* T, float* q, float* qd, float* minv, const float* act,
                      Work& w) {
  V3 xpos[NL];
  Q4 xrot[NL];
  fk(T, q, xpos, xrot);
  V3 cpos[NC1];
  float cpen[NC1];
  contacts(T, xpos, xrot, cpos, cpen);
  Com& s = w.com;
  transform_com(T, q, qd, xpos, xrot, s);
  mass_matrix(T, s, w.mx);
  inv_ns(w.mx, minv, w.t1, w.t2);

  // RNE bias force
  V3 cfrc_a[NL], cfrc_v[NL];
  V3 grav = ld3(T + T_GRAV);
  for (int l = 0; l < NL; ++l) {
    V3 cdd_a, cdd_v;
    bool first = true;
    for (int d = 0; d < ND; ++d) {
      if (!DOF_ANC[l][d]) continue;
      V3 a = s.cdofd_a[d] * qd[d], v = s.cdofd_v[d] * qd[d];
      cdd_a = first ? a : cdd_a + a;
      cdd_v = first ? v : cdd_v + v;
      first = false;
    }
    cdd_v = cdd_v - grav;
    float m = T[T_LINK + l * LINK_SIZE + L_MASS];
    V3 fa, fv, ia, iv;
    inertia_mul(s.cinr_i[l], s.cinr_h[l], m, cdd_a, cdd_v, fa, fv);
    inertia_mul(s.cinr_i[l], s.cinr_h[l], m, s.cd_a[l], s.cd_v[l], ia, iv);
    cfrc_a[l] = (fa + cross(s.cd_a[l], ia)) + cross(s.cd_v[l], iv);
    cfrc_v[l] = fv + cross(s.cd_a[l], iv);
  }
  float qf[ND];
  for (int d = 0; d < ND; ++d) {
    int l = DOF_LINK[d];
    V3 sa, sv;
    bool first = true;
    for (int k = 0; k < NL; ++k) {
      if (!SUB_LINK[l][k]) continue;
      sa = first ? cfrc_a[k] : sa + cfrc_a[k];
      sv = first ? cfrc_v[k] : sv + cfrc_v[k];
      first = false;
    }
    float bias = dot3(s.cdof_v[d], sv) + dot3(s.cdof_a[d], sa);
    const float* D = T + T_DOF + d * DOF_SIZE;
    float passive = -D[D_DAMP] * qd[d];
    if (HAS_STIFF[d]) passive = passive - q[Q_OFF[l] + (d - QD_OFF[l])] * D[D_STIFF];
    float tau = 0.0f;
    for (int k = 0; k < NA; ++k) {
      if (ACT_DOF[k] != d) continue;
      const float* A = T + T_ACT + k * ACT_SIZE;
      float force = fminf(fmaxf(act[k], A[1]), A[2]);
      tau = tau + A[0] * force;
    }
    qf[d] = passive - bias + tau;
  }

  float qfc[ND];
  for (int d = 0; d < ND; ++d) qfc[d] = 0.0f;
  if (NR > 0) {
    float pos_r[NR1], diag_r[NR1];
    for (int i = 0; i < NR * ND; ++i) w.jac[i] = 0.0f;
    for (int c = 0; c < NC; ++c) {
      const float* C = T + T_CON + c * CONTACT_SIZE;
      float active = cpen[c] > 0.0f ? 1.0f : 0.0f;
      V3 off = cpos[c] - s.com;
      for (int d = 0; d < ND; ++d) {
        if (!DOF_ANC[C_LINK[c]][d]) continue;
        V3 av = s.cdof_v[d] - cross(off, s.cdof_a[d]);
        for (int r = 0; r < 4; ++r) {
          const float* dir = C + C_DIRS + 3 * r;
          w.jac[(4 * c + r) * ND + d] = (dir[0] * av.x + dir[1] * av.y + dir[2] * av.z) * active;
        }
      }
      for (int r = 0; r < 4; ++r) {
        pos_r[4 * c + r] = (-cpen[c]) * active;
        diag_r[4 * c + r] = C[C_DIAG] * active;
      }
    }
    for (int i = 0; i < NLIM; ++i) {
      int d = LIM_D[i], row = 4 * NC + i;
      const float* D = T + T_DOF + d * DOF_SIZE;
      float qi = q[LIM_Q[i]];
      float pos_min = qi - D[D_LO], pos_max = D[D_HI] - qi;
      float pos = fminf(fminf(pos_min, pos_max), 0.0f);
      float closed = pos < 0.0f ? 1.0f : 0.0f;
      w.jac[row * ND + d] = ((pos_min < pos_max ? 1.0f : 0.0f) * 2.0f - 1.0f) * closed;
      pos_r[row] = pos;
      diag_r[row] = D[D_IW] * closed;
    }
    float bvec[NR1], xsol[NR1], diag_add[NR1];
    for (int i = 0; i < NR; ++i) {
      const float* ji = w.jac + i * ND;
      float jqd = 0.0f;
      bool first = true;
      for (int e = 0; e < ND; ++e) w.jm[i * ND + e] = 0.0f;
      for (int d = 0; d < ND; ++d) {
        if (!in_row(i, d)) continue;
        jqd = first ? ji[d] * qd[d] : jqd + ji[d] * qd[d];
        for (int e = 0; e < ND; ++e) {
          float v = ji[d] * minv[d * ND + e];
          w.jm[i * ND + e] = first ? v : w.jm[i * ND + e] + v;
        }
        first = false;
      }
      float imp, aref;
      imp_aref(pos_r[i], jqd, imp, aref);
      diag_add[i] = diag_r[i] * (1.0f - imp) / imp;
      bvec[i] = rowdot(w.jm + i * ND, qf, ND) - aref;
    }
    for (int i = 0; i < NR; ++i) {
      for (int j = i; j < NR; ++j) {
        // contract over the sparser row's support
        int a = i, b = j;
        if (!(ROW_NNZ[j] <= ROW_NNZ[i])) {
          a = j;
          b = i;
        }
        float v = 0.0f;
        bool first = true;
        for (int d = 0; d < ND; ++d) {
          if (!in_row(b, d)) continue;
          float t = w.jac[b * ND + d] * w.jm[a * ND + d];
          v = first ? t : v + t;
          first = false;
        }
        if (i == j) v = v + diag_add[i];
        w.amat[i * NR + j] = v;
        w.amat[j * NR + i] = v;
      }
    }
    fista(w.amat, bvec, xsol);
    for (int d = 0; d < ND; ++d) {
      bool first = true;
      for (int i = 0; i < NR; ++i) {
        if (!in_row(i, d)) continue;
        float t = w.jac[i * ND + d] * xsol[i];
        qfc[d] = first ? t : qfc[d] + t;
        first = false;
      }
    }
  }

  // damping folded into M^-1: qdd = (M^-1 - M^-1 diag(damping dt) M^-1) qf
  for (int i = 0; i < ND; ++i)
    for (int k = 0; k < ND; ++k)
      w.t1[i * ND + k] = minv[i * ND + k] * T[T_DOF + k * DOF_SIZE + D_DCOL];
  matmul(w.t1, minv, w.t2, true);
  float qft[ND], qdd[ND];
  for (int d = 0; d < ND; ++d) qft[d] = qf[d] + qfc[d];
  for (int i = 0; i < ND; ++i) {
    float v = 0.0f;
    for (int k = 0; k < ND; ++k) {
      float t = (minv[i * ND + k] - w.t2[i * ND + k]) * qft[k];
      v = k == 0 ? t : v + t;
    }
    qdd[i] = v;
  }

  // semi-implicit Euler
  float dt = T[T_DT];
  for (int d = 0; d < ND; ++d) qd[d] = qd[d] + qdd[d] * dt;
  for (int l = 0; l < NL; ++l) {
    int qo = Q_OFF[l], d0 = QD_OFF[l];
    if (LTYPE[l] != 0) {
      for (int i = 0; i < LTYPE[l]; ++i) q[qo + i] = q[qo + i] + qd[d0 + i] * dt;
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
}

__global__ void gen_step_kernel(const float* __restrict__ q_in, const float* __restrict__ qd_in,
                                const float* __restrict__ minv_in, const float* __restrict__ act_in,
                                float* __restrict__ q_out, float* __restrict__ qd_out,
                                float* __restrict__ minv_out, float* __restrict__ x_pos,
                                float* __restrict__ x_rot, float* __restrict__ xd_ang,
                                float* __restrict__ xd_vel, float* __restrict__ c_pos,
                                float* __restrict__ c_pen, const float* __restrict__ table, int n,
                                int n_frames) {
  __shared__ float T[T_SIZE];
  for (int i = threadIdx.x; i < T_SIZE; i += blockDim.x) T[i] = table[i];
  __syncthreads();
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;

  float q[NQ], qd[ND], minv[ND * ND], act[NA1];
  for (int i = 0; i < NQ; ++i) q[i] = q_in[i * n + e];
  for (int i = 0; i < ND; ++i) qd[i] = qd_in[i * n + e];
  for (int i = 0; i < ND * ND; ++i) minv[i] = minv_in[i * n + e];
  for (int i = 0; i < NA; ++i) act[i] = act_in[i * n + e];

  Work w;
  for (int f = 0; f < n_frames; ++f) frame(T, q, qd, minv, act, w);

  V3 xpos[NL], xda[NL], xdv[NL];
  Q4 xrot[NL];
  fk(T, q, xpos, xrot);
  fk_vel(T, q, qd, xpos, xrot, xda, xdv);
  V3 cpos[NC1];
  float cpen[NC1];
  contacts(T, xpos, xrot, cpos, cpen);

  for (int i = 0; i < NQ; ++i) q_out[i * n + e] = q[i];
  for (int i = 0; i < ND; ++i) qd_out[i * n + e] = qd[i];
  for (int i = 0; i < ND * ND; ++i) minv_out[i * n + e] = minv[i];
  for (int l = 0; l < NL; ++l) {
    float p[3] = {xpos[l].x, xpos[l].y, xpos[l].z};
    float r[4] = {xrot[l].w, xrot[l].x, xrot[l].y, xrot[l].z};
    float a[3] = {xda[l].x, xda[l].y, xda[l].z};
    float v[3] = {xdv[l].x, xdv[l].y, xdv[l].z};
    for (int k = 0; k < 3; ++k) {
      x_pos[(3 * l + k) * n + e] = p[k];
      xd_ang[(3 * l + k) * n + e] = a[k];
      xd_vel[(3 * l + k) * n + e] = v[k];
    }
    for (int k = 0; k < 4; ++k) x_rot[(4 * l + k) * n + e] = r[k];
  }
  for (int c = 0; c < NC; ++c) {
    c_pos[(3 * c) * n + e] = cpos[c].x;
    c_pos[(3 * c + 1) * n + e] = cpos[c].y;
    c_pos[(3 * c + 2) * n + e] = cpos[c].z;
    c_pen[c * n + e] = cpen[c];
  }
}

}  // namespace

extern "C" int brax_gen_step_sizes(int* out) {
  out[0] = NL;
  out[1] = NQ;
  out[2] = ND;
  out[3] = NC;
  out[4] = NA;
  out[5] = NR;
  return 0;
}

extern "C" int brax_gen_step(const float* q, const float* qd, const float* minv, const float* act,
                             float* q_out, float* qd_out, float* minv_out, float* x_pos,
                             float* x_rot, float* xd_ang, float* xd_vel, float* c_pos,
                             float* c_pen, const float* table, int n, int n_frames, int block,
                             void* stream) {
  if (n <= 0) return 0;
  int grid = (n + block - 1) / block;
  gen_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      q, qd, minv, act, q_out, qd_out, minv_out, x_pos, x_rot, xd_ang, xd_vel, c_pos, c_pen, table,
      n, n_frames);
  return (int)cudaGetLastError();
}
