// The screen-space preprocess of every render, forward and backward, one
// thread per gaussian row.
//
// Replaces XLA's fusion of hidegs_tpu/raster/preprocess.py:preprocess_gaussians
// with hidegs_tpu/core/ewa.py:project_gaussians_scq and hidegs_tpu/core/sh.py
// (no Pallas kernel: the JAX package leaves it to XLA and to jax.vjp). The
// TPU shape of that code, every intermediate an (N,) component array, is
// one launch per component on this card, and its backward another launch
// and an accumulation per component; here each row's whole chain, forward
// or backward, stays in registers.
//
//   * hidegs_preprocess_fwd: the EWA projection straight from (scales,
//     quats) with the tangent clamp, H_VAR and NEAR_Z; the antialias
//     opacity rescale, the conic and the radius; SH -> RGB for degrees 0-3
//     with the band mask (the (N, K, 3) and flat (N, 3K) layouts are the
//     same memory) or the precomputed colors; the render_geo normal and
//     distance; the screen-bounds, chunk-AABB and box_exempt culls; the
//     ten outputs of PreprocessedGaussians. Its plain version is
//     raster/preprocess.py:preprocess_plain, whose op order it keeps.
//   * hidegs_preprocess_bwd: the chain rule by hand, term for term as
//     raster/preprocess.py:preprocess_plain_bwd writes it (that function is
//     this kernel's derivation in PyTorch, held against torch autograd of
//     preprocess_plain and against jax.vjp on the CPU), with torch
//     autograd's rules at ties: clamps pass their bounds, `where` masks,
//     argmin takes the first minimum, sqrt's derivative is g / (2 sqrt).
//     Any cotangent may be absent (a null pointer: zero). Each thread
//     writes its own row of every gradient: no atomics, so the gradients
//     are bitwise reproducible.
//
// Bound on this card: bytes. Per row the forward reads ~260 B (means,
// scales, quats, opacity, 48 SH floats) and writes ~84 B; the backward
// reads the same inputs, the mask and ~80 B of cotangents and writes
// ~256 B of gradients: ~350 B and ~560 B a row, ~0.1 and ~0.2 ms at 1.26M
// rows at 3.35 TB/s. The arithmetic (a few hundred flops a row) is far
// below the card's rate. Built with -fmad=false, as the blend kernels, so
// the forward rounds as the plain version does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// raster/preprocess.py:camera_pack
constexpr int PACK_R = 0, PACK_T = 9, PACK_F = 12, PACK_C = 14, PACK_LIM = 16, PACK_CENTER = 20;
// the `flags` bits (raster/preprocess_autograd.py)
constexpr int USE_SH = 1, ANTIALIAS = 2, RENDER_GEO = 4, SCREEN = 8, BOX = 16;
constexpr int THREADS = 256;

// core/sh.py's constants, rounded to float32 as torch rounds a Python
// scalar in a float32 op
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f, C2_2 = 0.31539156525252005f,
                C2_3 = -1.0925484305920792f, C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f, C3_2 = -0.4570457994644658f,
                C3_3 = 0.3731763325901154f, C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

struct Cam {
  float R[3][3], t[3], fx, fy, cx, cy, lox, hix, loy, hiy, center[3];
};

__device__ __forceinline__ Cam load_cam(const float* p) {
  Cam c;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) c.R[i][j] = p[PACK_R + 3 * i + j];
    c.t[i] = p[PACK_T + i];
    c.center[i] = p[PACK_CENTER + i];
  }
  c.fx = p[PACK_F];
  c.fy = p[PACK_F + 1];
  c.cx = p[PACK_C];
  c.cy = p[PACK_C + 1];
  c.lox = p[PACK_LIM];
  c.hix = p[PACK_LIM + 1];
  c.loy = p[PACK_LIM + 2];
  c.hiy = p[PACK_LIM + 3];
  return c;
}

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp2(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }

// The EWA projection's intermediates (core/ewa.py:project_gaussians_scq).
struct Proj {
  float p[3];       // camera-frame mean
  float zs, vx, vy; // clamped depth, px/zs, py/zs
  float j00, j02, j11, j12;
  float A[2][3];    // J·R_cam
  float q[4];       // unit quaternion (w, x, y, z)
  float qinv;       // rsqrt(|quat|² + 1e-12)
  float r[3][3];    // R(q)
  float T[2][3];    // A·R(q)
  float B[2][3];    // T·diag(s)
  float a, b, c, det_raw, a_d, c_d, det_d, dcl, inv_det;
};

__device__ __forceinline__ void project(const Cam& cam, const float m[3], const float s[3], const float quat[4],
                                        float h_var, float near_z, Proj& P) {
  for (int i = 0; i < 3; ++i)
    P.p[i] = cam.R[i][0] * m[0] + cam.R[i][1] * m[1] + cam.R[i][2] * m[2] + cam.t[i];
  P.zs = clamp_min(P.p[2], near_z);
  P.vx = P.p[0] / P.zs;
  P.vy = P.p[1] / P.zs;
  const float txz = clamp2(P.vx, cam.lox, cam.hix);
  const float tyz = clamp2(P.vy, cam.loy, cam.hiy);
  P.j00 = cam.fx / P.zs;
  P.j11 = cam.fy / P.zs;
  P.j02 = -cam.fx * txz / P.zs;
  P.j12 = -cam.fy * tyz / P.zs;
  for (int k = 0; k < 3; ++k) {
    P.A[0][k] = P.j00 * cam.R[0][k] + P.j02 * cam.R[2][k];
    P.A[1][k] = P.j11 * cam.R[1][k] + P.j12 * cam.R[2][k];
  }
  const float n2 = quat[0] * quat[0] + quat[1] * quat[1] + quat[2] * quat[2] + quat[3] * quat[3];
  P.qinv = 1.0f / sqrtf(n2 + 1e-12f);
  for (int k = 0; k < 4; ++k) P.q[k] = quat[k] * P.qinv;
  const float w = P.q[0], x = P.q[1], y = P.q[2], z = P.q[3];
  P.r[0][0] = 1.0f - 2.0f * (y * y + z * z);
  P.r[0][1] = 2.0f * (x * y - w * z);
  P.r[0][2] = 2.0f * (x * z + w * y);
  P.r[1][0] = 2.0f * (x * y + w * z);
  P.r[1][1] = 1.0f - 2.0f * (x * x + z * z);
  P.r[1][2] = 2.0f * (y * z - w * x);
  P.r[2][0] = 2.0f * (x * z - w * y);
  P.r[2][1] = 2.0f * (y * z + w * x);
  P.r[2][2] = 1.0f - 2.0f * (x * x + y * y);
  for (int a = 0; a < 2; ++a)
    for (int j = 0; j < 3; ++j) {
      P.T[a][j] = P.A[a][0] * P.r[0][j] + P.A[a][1] * P.r[1][j] + P.A[a][2] * P.r[2][j];
      P.B[a][j] = P.T[a][j] * s[j];
    }
  P.a = P.B[0][0] * P.B[0][0] + P.B[0][1] * P.B[0][1] + P.B[0][2] * P.B[0][2];
  P.b = P.B[0][0] * P.B[1][0] + P.B[0][1] * P.B[1][1] + P.B[0][2] * P.B[1][2];
  P.c = P.B[1][0] * P.B[1][0] + P.B[1][1] * P.B[1][1] + P.B[1][2] * P.B[1][2];
  P.det_raw = P.a * P.c - P.b * P.b;
  P.a_d = P.a + h_var;
  P.c_d = P.c + h_var;
  P.det_d = P.a_d * P.c_d - P.b * P.b;
  P.dcl = clamp_min(P.det_d, 1e-12f);
  P.inv_det = 1.0f / P.dcl;
}

// argmin over the three scales: the first minimum, as torch.argmin
__device__ __forceinline__ int argmin3(const float s[3]) {
  int idx = 0;
  float best = s[0];
  if (s[1] < best) {
    idx = 1;
    best = s[1];
  }
  if (s[2] < best) idx = 2;
  return idx;
}

// The smallest axis's column of R(q) in the camera frame and the unflipped
// n · p (raster/preprocess.py's render_geo branch). Every array here and
// below is indexed by compile-time constants only (a runtime index would
// put it in local memory).
__device__ __forceinline__ float geo_normal(const Cam& cam, const Proj& P, int idx, float ncam[3]) {
  float nw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) nw[i] = idx == 0 ? P.r[i][0] : (idx == 1 ? P.r[i][1] : P.r[i][2]);
  for (int i = 0; i < 3; ++i) ncam[i] = cam.R[i][0] * nw[0] + cam.R[i][1] * nw[1] + cam.R[i][2] * nw[2];
  return ncam[0] * P.p[0] + ncam[1] * P.p[1] + ncam[2] * P.p[2];
}

// Unit view direction (core/sh.py:eval_sh's normalisation) and its rsqrt.
__device__ __forceinline__ float view_dir(const Cam& cam, const float m[3], float d[3], float u[3]) {
  for (int k = 0; k < 3; ++k) d[k] = m[k] - cam.center[k];
  const float inv = 1.0f / sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-24f);
  for (int k = 0; k < 3; ++k) u[k] = d[k] * inv;
  return inv;
}

// core/sh.py:_sh_basis_components, times the band mask
__device__ __forceinline__ void sh_basis_masked(const float u[3], const float* mask, int K, float bm[16]) {
  const float x = u[0], y = u[1], z = u[2];
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  float b[16];
  b[0] = C0 * 1.0f;
  b[1] = -C1 * y;
  b[2] = C1 * z;
  b[3] = -C1 * x;
  b[4] = C2_0 * xy;
  b[5] = C2_1 * yz;
  b[6] = C2_2 * (2.0f * zz - xx - yy);
  b[7] = C2_3 * xz;
  b[8] = C2_4 * (xx - yy);
  b[9] = C3_0 * y * (3.0f * xx - yy);
  b[10] = C3_1 * xy * z;
  b[11] = C3_2 * y * (4.0f * zz - xx - yy);
  b[12] = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  b[13] = C3_4 * x * (4.0f * zz - xx - yy);
  b[14] = C3_5 * z * (xx - yy);
  b[15] = C3_6 * x * (xx - 3.0f * yy);
#pragma unroll
  for (int k = 0; k < 16; ++k) bm[k] = k < K ? b[k] * mask[k] : 0.0f;
}

// Σ_k bm_k · sh_kc in k order (the flat branch of core/sh.py:eval_sh)
__device__ __forceinline__ void sh_eval(const float bm[16], const float* sh, int K, float ev[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) ev[c] = bm[0] * sh[c];
#pragma unroll
  for (int k = 1; k < 16; ++k)
    if (k < K)
#pragma unroll
      for (int c = 0; c < 3; ++c) ev[c] = ev[c] + bm[k] * sh[3 * k + c];
}

struct FwdArgs {
  const float *means, *scales, *quats, *opac, *color, *offset, *params, *mask, *boxmin, *boxmax;
  const uint8_t* exempt;
  int N, K, flags;
  float h_var, near_z, w_pad, h_pad;
  float *mean2d, *conic, *depth, *inv_depth, *opacity, *rgb, *normal, *distance;
  int* radius;
  uint8_t* visible;
};

__global__ void __launch_bounds__(THREADS) preprocess_fwd_kernel(const FwdArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.N) return;
  const Cam cam = load_cam(a.params);
  const float m[3] = {a.means[3 * i], a.means[3 * i + 1], a.means[3 * i + 2]};
  const float s[3] = {a.scales[3 * i], a.scales[3 * i + 1], a.scales[3 * i + 2]};
  const float quat[4] = {a.quats[4 * i], a.quats[4 * i + 1], a.quats[4 * i + 2], a.quats[4 * i + 3]};
  Proj P;
  project(cam, m, s, quat, a.h_var, a.near_z, P);

  const float ratio = P.det_raw / P.dcl;
  const float aa = sqrtf(clamp_min(ratio, 0.0f));
  const float mid = 0.5f * (P.a_d + P.c_d);
  const float lam1 = mid + sqrtf(clamp_min(mid * mid - P.det_d, 0.1f));
  const bool valid = (P.p[2] > a.near_z) && (P.det_d > 0.0f);
  const float radius = valid ? ceilf(3.0f * sqrtf(lam1)) : 0.0f;
  float u = cam.fx * P.vx + cam.cx;
  float v = cam.fy * P.vy + cam.cy;
  if (a.offset) {
    u = u + a.offset[2 * i];
    v = v + a.offset[2 * i + 1];
  }

  float rgb[3];
  if (a.flags & USE_SH) {
    float d[3], un[3], bm[16];
    view_dir(cam, m, d, un);
    sh_basis_masked(un, a.mask, a.K, bm);
    float ev[3];
    sh_eval(bm, a.color + (size_t)i * 3 * a.K, a.K, ev);
    for (int c = 0; c < 3; ++c) rgb[c] = clamp_min(ev[c] + 0.5f, 0.0f);
  } else {
    for (int c = 0; c < 3; ++c) rgb[c] = a.color[3 * i + c];
  }
  const float op = a.opac[i];
  const float opac = (a.flags & ANTIALIAS) ? op * aa : op * 1.0f;

  float normal[3] = {0.0f, 0.0f, 0.0f}, distance = 0.0f;
  if (a.flags & RENDER_GEO) {
    float ncam[3];
    const float dot = geo_normal(cam, P, argmin3(s), ncam);
    const float flip = dot > 0.0f ? -1.0f : 1.0f;
    for (int k = 0; k < 3; ++k) normal[k] = ncam[k] * flip;
    distance = -flip * dot;
  }

  bool vis = valid && radius > 0.0f;
  if (a.flags & SCREEN)
    vis = vis && (u + radius > 0.0f) && (u - radius < a.w_pad) && (v + radius > 0.0f) && (v - radius < a.h_pad);
  if (a.flags & BOX) {
    bool inside = true;
    for (int k = 0; k < 3; ++k) inside = inside && (m[k] >= a.boxmin[k]) && (m[k] <= a.boxmax[k]);
    if (a.exempt) inside = inside || a.exempt[i];
    vis = vis && inside;
  }
  const float safe_z = clamp_min(P.p[2], a.near_z);

  a.mean2d[2 * i] = u;
  a.mean2d[2 * i + 1] = v;
  a.conic[3 * i] = P.c_d * P.inv_det;
  a.conic[3 * i + 1] = -P.b * P.inv_det;
  a.conic[3 * i + 2] = P.a_d * P.inv_det;
  a.depth[i] = P.p[2];
  a.inv_depth[i] = vis ? 1.0f / safe_z : 0.0f;
  a.opacity[i] = vis ? opac : 0.0f;
  for (int k = 0; k < 3; ++k) {
    a.rgb[3 * i + k] = rgb[k];
    a.normal[3 * i + k] = normal[k];
  }
  a.distance[i] = distance;
  a.radius[i] = vis ? (int)radius : 0;
  a.visible[i] = vis ? 1 : 0;
}

struct BwdArgs {
  const float *means, *scales, *quats, *opac, *color, *params, *mask;
  const uint8_t* visible;
  const float *g_mean2d, *g_conic, *g_depth, *g_inv_depth, *g_opacity, *g_rgb, *g_normal, *g_distance;
  int N, K, flags;
  float h_var, near_z;
  float *d_means, *d_scales, *d_quats, *d_opac, *d_color, *d_offset;
};

__global__ void __launch_bounds__(THREADS) preprocess_bwd_kernel(const BwdArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.N) return;
  const Cam cam = load_cam(a.params);
  const float m[3] = {a.means[3 * i], a.means[3 * i + 1], a.means[3 * i + 2]};
  const float s[3] = {a.scales[3 * i], a.scales[3 * i + 1], a.scales[3 * i + 2]};
  const float quat[4] = {a.quats[4 * i], a.quats[4 * i + 1], a.quats[4 * i + 2], a.quats[4 * i + 3]};
  const bool vis = a.visible[i] != 0;
  const float near_z = a.near_z;
  Proj P;
  project(cam, m, s, quat, a.h_var, near_z, P);

  // screen space: mean2d, depth, inv_depth, opacity, conic
  float d_p[3] = {0.0f, 0.0f, 0.0f}, d_zs = 0.0f, d_vx = 0.0f, d_vy = 0.0f;
  if (a.g_mean2d) {
    d_vx = a.g_mean2d[2 * i] * cam.fx;
    d_vy = a.g_mean2d[2 * i + 1] * cam.fy;
  }
  if (a.g_depth) d_p[2] = d_p[2] + a.g_depth[i];
  if (a.g_inv_depth) {
    const float rz = 1.0f / clamp_min(P.p[2], near_z);
    const float d_sz = -(vis ? a.g_inv_depth[i] : 0.0f) * (rz * rz);
    d_p[2] = d_p[2] + (P.p[2] >= near_z ? d_sz : 0.0f);
  }
  const float d_opac = (a.g_opacity && vis) ? a.g_opacity[i] : 0.0f;
  float d_ad = 0.0f, d_cd = 0.0f, d_b = 0.0f, d_dcl = 0.0f;
  if (a.g_conic) {
    const float g0 = a.g_conic[3 * i], g1 = a.g_conic[3 * i + 1], g2 = a.g_conic[3 * i + 2];
    d_cd = g0 * P.inv_det;
    d_b = -(g1 * P.inv_det);
    d_ad = g2 * P.inv_det;
    const float d_inv = g0 * P.c_d + g1 * -P.b + g2 * P.a_d;
    d_dcl = -d_inv * (P.inv_det * P.inv_det);
  }
  float d_a = 0.0f, d_c = 0.0f, d_opacities;
  if (a.flags & ANTIALIAS) {
    const float ratio = P.det_raw / P.dcl;
    const float aa = sqrtf(clamp_min(ratio, 0.0f));
    d_opacities = d_opac * aa;
    if (a.g_opacity) {
      const float d_ratio = ratio >= 0.0f ? (d_opac * a.opac[i]) / (2.0f * aa) : 0.0f;
      const float d_raw = d_ratio / P.dcl;
      d_dcl = d_dcl - d_ratio * (ratio / P.dcl);
      d_a = d_raw * P.c;
      d_c = d_raw * P.a;
      d_b = d_b - 2.0f * P.b * d_raw;
    }
  } else {
    d_opacities = d_opac;
  }
  const float d_det = P.det_d >= 1e-12f ? d_dcl : 0.0f;
  d_ad = d_ad + d_det * P.c_d;
  d_cd = d_cd + d_det * P.a_d;
  d_b = d_b - 2.0f * P.b * d_det;
  d_a = d_a + d_ad;
  d_c = d_c + d_cd;

  // the 2x3 factor B = A·R(q)·diag(s), then A = J·R_cam
  float dB[2][3], dT[2][3], d_s[3], dA[2][3], dr[3][3];
  for (int j = 0; j < 3; ++j) {
    dB[0][j] = 2.0f * P.B[0][j] * d_a + P.B[1][j] * d_b;
    dB[1][j] = 2.0f * P.B[1][j] * d_c + P.B[0][j] * d_b;
    d_s[j] = dB[0][j] * P.T[0][j] + dB[1][j] * P.T[1][j];
    dT[0][j] = dB[0][j] * s[j];
    dT[1][j] = dB[1][j] * s[j];
  }
  for (int b = 0; b < 2; ++b)
    for (int k = 0; k < 3; ++k) dA[b][k] = dT[b][0] * P.r[k][0] + dT[b][1] * P.r[k][1] + dT[b][2] * P.r[k][2];
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 3; ++j) dr[k][j] = dT[0][j] * P.A[0][k] + dT[1][j] * P.A[1][k];
  const float d_j00 = dA[0][0] * cam.R[0][0] + dA[0][1] * cam.R[0][1] + dA[0][2] * cam.R[0][2];
  const float d_j02 = dA[0][0] * cam.R[2][0] + dA[0][1] * cam.R[2][1] + dA[0][2] * cam.R[2][2];
  const float d_j11 = dA[1][0] * cam.R[1][0] + dA[1][1] * cam.R[1][1] + dA[1][2] * cam.R[1][2];
  const float d_j12 = dA[1][0] * cam.R[2][0] + dA[1][1] * cam.R[2][1] + dA[1][2] * cam.R[2][2];
  d_zs = d_zs - d_j00 * (P.j00 / P.zs) - d_j11 * (P.j11 / P.zs) - d_j02 * (P.j02 / P.zs) - d_j12 * (P.j12 / P.zs);
  d_vx = d_vx + ((P.vx >= cam.lox && P.vx <= cam.hix) ? (d_j02 / P.zs) * -cam.fx : 0.0f);
  d_vy = d_vy + ((P.vy >= cam.loy && P.vy <= cam.hiy) ? (d_j12 / P.zs) * -cam.fy : 0.0f);
  d_p[0] = d_p[0] + d_vx / P.zs;
  d_p[1] = d_p[1] + d_vy / P.zs;
  d_zs = d_zs - d_vx * (P.vx / P.zs) - d_vy * (P.vy / P.zs);
  d_p[2] = d_p[2] + (P.p[2] >= near_z ? d_zs : 0.0f);

  if ((a.flags & RENDER_GEO) && (a.g_normal || a.g_distance)) {
    const int idx = argmin3(s);
    float ncam[3];
    const float dot = geo_normal(cam, P, idx, ncam);
    const float flip = dot > 0.0f ? -1.0f : 1.0f;
    const float d_dot = a.g_distance ? a.g_distance[i] * -flip : 0.0f;
    float d_nc[3];
    for (int k = 0; k < 3; ++k) {
      d_nc[k] = d_dot * P.p[k];
      if (a.g_normal) d_nc[k] = d_nc[k] + a.g_normal[3 * i + k] * flip;
    }
    for (int k = 0; k < 3; ++k) d_p[k] = d_p[k] + d_dot * ncam[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d_nw = cam.R[0][k] * d_nc[0] + cam.R[1][k] * d_nc[1] + cam.R[2][k] * d_nc[2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j == idx) dr[k][j] = dr[k][j] + d_nw;
    }
  }

  float d_m[3];
  for (int k = 0; k < 3; ++k) d_m[k] = cam.R[0][k] * d_p[0] + cam.R[1][k] * d_p[1] + cam.R[2][k] * d_p[2];

  // SH -> RGB
  const int width = (a.flags & USE_SH) ? 3 * a.K : 3;
  float* d_color = a.d_color ? a.d_color + (size_t)i * width : nullptr;
  if ((a.flags & USE_SH) && a.g_rgb) {
    const float* sh = a.color + (size_t)i * 3 * a.K;
    float d[3], un[3], bm[16], ev[3], d_ev[3];
    const float dinv = view_dir(cam, m, d, un);
    sh_basis_masked(un, a.mask, a.K, bm);
    sh_eval(bm, sh, a.K, ev);
    for (int c = 0; c < 3; ++c) d_ev[c] = ev[c] + 0.5f >= 0.0f ? a.g_rgb[3 * i + c] : 0.0f;
    float gx[16], gy[16], gz[16];
    {
      const float x = un[0], y = un[1], z = un[2];
      const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
      gx[0] = 0.0f, gy[0] = 0.0f, gz[0] = 0.0f;
      gx[1] = 0.0f, gy[1] = -C1 * 1.0f, gz[1] = 0.0f;
      gx[2] = 0.0f, gy[2] = 0.0f, gz[2] = C1 * 1.0f;
      gx[3] = -C1 * 1.0f, gy[3] = 0.0f, gz[3] = 0.0f;
      gx[4] = C2_0 * y, gy[4] = C2_0 * x, gz[4] = 0.0f;
      gx[5] = 0.0f, gy[5] = C2_1 * z, gz[5] = C2_1 * y;
      gx[6] = -2.0f * C2_2 * x, gy[6] = -2.0f * C2_2 * y, gz[6] = 4.0f * C2_2 * z;
      gx[7] = C2_3 * z, gy[7] = 0.0f, gz[7] = C2_3 * x;
      gx[8] = 2.0f * C2_4 * x, gy[8] = -2.0f * C2_4 * y, gz[8] = 0.0f;
      gx[9] = 6.0f * C3_0 * xy, gy[9] = 3.0f * C3_0 * (xx - yy), gz[9] = 0.0f;
      gx[10] = C3_1 * yz, gy[10] = C3_1 * xz, gz[10] = C3_1 * xy;
      gx[11] = -2.0f * C3_2 * xy, gy[11] = C3_2 * (4.0f * zz - xx - 3.0f * yy), gz[11] = 8.0f * C3_2 * yz;
      gx[12] = -6.0f * C3_3 * xz, gy[12] = -6.0f * C3_3 * yz, gz[12] = C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      gx[13] = C3_4 * (4.0f * zz - 3.0f * xx - yy), gy[13] = -2.0f * C3_4 * xy, gz[13] = 8.0f * C3_4 * xz;
      gx[14] = 2.0f * C3_5 * xz, gy[14] = -2.0f * C3_5 * yz, gz[14] = C3_5 * (xx - yy);
      gx[15] = 3.0f * C3_6 * (xx - yy), gy[15] = -6.0f * C3_6 * xy, gz[15] = 0.0f;
    }
    float d_un[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k >= a.K) break;
      const float d_bm = (sh[3 * k] * d_ev[0] + sh[3 * k + 1] * d_ev[1] + sh[3 * k + 2] * d_ev[2]) * a.mask[k];
      d_un[0] = d_un[0] + d_bm * gx[k];
      d_un[1] = d_un[1] + d_bm * gy[k];
      d_un[2] = d_un[2] + d_bm * gz[k];
      if (d_color)
        for (int c = 0; c < 3; ++c) d_color[3 * k + c] = bm[k] * d_ev[c];
    }
    // n = d · rsqrt(Σ d² + eps)
    const float d_inv = d_un[0] * d[0] + d_un[1] * d[1] + d_un[2] * d[2];
    const float d_n2 = -0.5f * d_inv * (dinv * dinv * dinv);
    for (int k = 0; k < 3; ++k) d_m[k] = d_m[k] + (d_un[k] * dinv + 2.0f * d[k] * d_n2);
  } else if (d_color) {
    for (int k = 0; k < width; ++k) d_color[k] = (a.flags & USE_SH) || !a.g_rgb ? 0.0f : a.g_rgb[3 * i + k];
  }

  if (a.d_means)
    for (int k = 0; k < 3; ++k) a.d_means[3 * i + k] = d_m[k];
  if (a.d_scales)
    for (int k = 0; k < 3; ++k) a.d_scales[3 * i + k] = d_s[k];
  if (a.d_opac) a.d_opac[i] = d_opacities;
  if (a.d_offset) {
    a.d_offset[2 * i] = a.g_mean2d ? a.g_mean2d[2 * i] : 0.0f;
    a.d_offset[2 * i + 1] = a.g_mean2d ? a.g_mean2d[2 * i + 1] : 0.0f;
  }
  if (a.d_quats) {
    // R(q)'s rows through the unit quaternion, then its rsqrt normalisation
    const float w = P.q[0], x = P.q[1], y = P.q[2], z = P.q[3];
    float dq[4];
    dq[0] = 2.0f * (-z * dr[0][1] + y * dr[0][2] + z * dr[1][0] - x * dr[1][2] - y * dr[2][0] + x * dr[2][1]);
    dq[1] = 2.0f * (y * dr[0][1] + z * dr[0][2] + y * dr[1][0] - 2.0f * x * dr[1][1] - w * dr[1][2]
                    + z * dr[2][0] + w * dr[2][1] - 2.0f * x * dr[2][2]);
    dq[2] = 2.0f * (-2.0f * y * dr[0][0] + x * dr[0][1] + w * dr[0][2] + x * dr[1][0] + z * dr[1][2]
                    - w * dr[2][0] + z * dr[2][1] - 2.0f * y * dr[2][2]);
    dq[3] = 2.0f * (-2.0f * z * dr[0][0] - w * dr[0][1] + x * dr[0][2] + w * dr[1][0] - 2.0f * z * dr[1][1]
                    + y * dr[1][2] + x * dr[2][0] + y * dr[2][1]);
    const float d_inv = dq[0] * quat[0] + dq[1] * quat[1] + dq[2] * quat[2] + dq[3] * quat[3];
    const float d_n2 = -0.5f * d_inv * (P.qinv * P.qinv * P.qinv);
    for (int k = 0; k < 4; ++k) a.d_quats[4 * i + k] = dq[k] * P.qinv + 2.0f * quat[k] * d_n2;
  }
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int hidegs_preprocess_fwd(
    const float* means, const float* scales, const float* quats, const float* opac, const float* color,
    const float* offset, const float* params, const float* mask, const float* boxmin, const float* boxmax,
    const uint8_t* exempt, int N, int K, int flags, float h_var, float near_z, float w_pad, float h_pad,
    float* mean2d, float* conic, float* depth, float* inv_depth, float* opacity, float* rgb, float* normal,
    float* distance, int* radius, uint8_t* visible, cudaStream_t stream) {
  if (N <= 0) return 0;
  const FwdArgs a{means, scales, quats, opac, color, offset, params, mask, boxmin, boxmax, exempt, N, K, flags,
                  h_var, near_z, w_pad, h_pad, mean2d, conic, depth, inv_depth, opacity, rgb, normal, distance,
                  radius, visible};
  preprocess_fwd_kernel<<<blocks(N), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int hidegs_preprocess_bwd(
    const float* means, const float* scales, const float* quats, const float* opac, const float* color,
    const float* params, const float* mask, const uint8_t* visible, const float* g_mean2d, const float* g_conic,
    const float* g_depth, const float* g_inv_depth, const float* g_opacity, const float* g_rgb,
    const float* g_normal, const float* g_distance, int N, int K, int flags, float h_var, float near_z,
    float* d_means, float* d_scales, float* d_quats, float* d_opac, float* d_color, float* d_offset,
    cudaStream_t stream) {
  if (N <= 0) return 0;
  const BwdArgs a{means, scales, quats, opac, color, params, mask, visible, g_mean2d, g_conic, g_depth,
                  g_inv_depth, g_opacity, g_rgb, g_normal, g_distance, N, K, flags, h_var, near_z,
                  d_means, d_scales, d_quats, d_opac, d_color, d_offset};
  preprocess_bwd_kernel<<<blocks(N), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
