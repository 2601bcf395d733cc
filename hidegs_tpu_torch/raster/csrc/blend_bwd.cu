// Backward tile blend for NVIDIA Hopper (sm_90a), written by hand, and the
// fold of its per-instance gradient rows into per-gaussian rows.
//
// blend_bwd_kernel replaces hidegs_tpu/raster/pallas_vjp.py:_passB_kernel
// (launched by blend_tiles_pallas_bwd). Same function, not the same layout:
// the TPU kernel walks a sequential grid of 128-instance blocks with VMEM
// carries and writes an (ATTR, block) tile tagged with float32 gaussian ids;
// here one CTA owns one tile and walks its whole span, as blend_fwd.cu does.
//
//   * 256 threads own the tile's pixels: one each at tile 16, four each at
//     tile 32. Per pixel, in registers: the cotangents g[0:9], G_total and
//     T_final·g_T (channels 10 and 11 of the augmented cotangent planes),
//     the log-transmittance carry (float64, rounded to float32 before each
//     exp, exactly as blend_fwd.cu does it), T and the float32 running
//     prefix Σ w·chg.
//   * Batches of 64 instances are gathered through gauss_id into shared
//     memory. Per pixel and instance, front to back:
//       α, keep, T_excl, T_incl as in the forward kernel
//       w      = T_excl·α·m,  m = [T_incl ≥ 1e-4]
//       chg    = Σ_c g_c·channel_c  (rgb, invdepth, normal, distance, 1)
//       prefix += w·chg;  S = G_total − prefix + T_final·g_T
//       dα     = T_excl·m·chg − S/(1−α)
//       dpower = dα·α and dop = dα·exp(power), where α_raw < 0.99
//     and from these the 14 gradient values of the instance's packed row:
//     d_mean2d (2), d_conic (3), d_opacity, and Σ g_c·w for the 8 channels.
//     A pixel whose T fell below 1e-4 is done, as in the forward; the CTA
//     stops once every pixel is done.
//   * Reduction over the tile's pixels, in a fixed order: each thread sums
//     its own pixels, a warp sums its lanes with a shuffle butterfly, and
//     the per-warp partials (shared memory) are summed in warp order. One
//     row per sorted instance is written; no atomics. Instances after the
//     CTA stops keep the zero rows the wrapper allocated.
//
// fold_rows_kernel sums the rows, permuted into expansion order (where each
// gaussian's instances are contiguous), over each gaussian's span
// [g_start[g], g_start[g+1]) in slot order: one thread per (gaussian,
// column). It takes the place of the segment sum of pallas_vjp.py:455 and
// of a float index_add_, whose atomics would make gradients differ from run
// to run. Its order is the plain version's (blend_plain.fold_rows on the
// CPU), so the two agree to the bit there.
//
// What bounds the backward: the per-(pixel, instance) arithmetic, as in the
// forward. Each reached pair costs the forward's ~16 ops and one exp; each
// kept pair adds a log1p, an exp, one more exp for dop and ~60 ops (chg,
// the prefix, dα and the 14 gradient terms). The warp reductions (14 values
// x 5 shuffles per instance and warp) run only for warps where some lane
// kept the instance. Bytes (a 64-byte row per instance in and out, 64 bytes
// of cotangents per pixel) are small beside that. The design keeps it
// simple: load balance across tiles and the serial walk of long spans are
// left as they are in the forward.
//
// Built with -fmad=false and without --use_fast_math, like blend_fwd.cu, so
// α, T and the cutoffs are bitwise the forward kernel's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;  // instances staged per shared-memory batch
constexpr int kRow = 16;    // floats per packed row
constexpr int kGrad = 14;   // gradient values per row (the rest is padding)
constexpr float kTEps = 1e-4f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr unsigned kFull = 0xffffffffu;

// Packed gaussian row, 16 floats = 4 float4:
//   [0] mean_x mean_y conic_a conic_b   [1] conic_c opacity r g
//   [2] b invdepth normal_x normal_y    [3] normal_z distance pad pad
// Augmented cotangent row per pixel, 16 floats = 4 float4:
//   g[0:10] (rgb, invdepth, normal, distance, acc_alpha, T_final),
//   [10] G_total, [11] T_final·g_T, [12:16] unused.
template <int TILE>
__global__ void __launch_bounds__(kThreads)
blend_bwd_kernel(const float4* __restrict__ gattr,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count,
                 int tiles_x,
                 const float4* __restrict__ g_aug,
                 float* __restrict__ rows) {
  constexpr int P = TILE * TILE;
  constexpr int PPT = P / kThreads;  // pixels per thread
  static_assert(PPT * kThreads == P, "tile must be 16 or 32");
  static_assert(kBatch <= kThreads, "one staged row per thread");

  __shared__ float4 s_attr[kBatch][4];
  __shared__ float s_part[kBatch][kWarps][kGrad];

  const int t = blockIdx.x;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ox = (t % tiles_x) * TILE;
  const int oy = (t / tiles_x) * TILE;

  float px[PPT], py[PPT], T[PPT], prefix[PPT], g[PPT][9], g_tot[PPT], s_base[PPT];
  double S[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * kThreads;
    px[k] = (float)(p % TILE) + 0.5f + (float)ox;
    py[k] = (float)(p / TILE) + 0.5f + (float)oy;
    S[k] = 0.0;
    T[k] = 1.0f;
    prefix[k] = 0.0f;
    const float4* gr = g_aug + 4 * ((size_t)t * P + p);
    const float4 q0 = gr[0], q1 = gr[1], q2 = gr[2];
    g[k][0] = q0.x; g[k][1] = q0.y; g[k][2] = q0.z; g[k][3] = q0.w;
    g[k][4] = q1.x; g[k][5] = q1.y; g[k][6] = q1.z; g[k][7] = q1.w;
    g[k][8] = q2.x;
    g_tot[k] = q2.z;
    s_base[k] = q2.w;
  }

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int n = min(kBatch, count - b0);
    __syncthreads();  // the previous batch is fully consumed
    if (tid < n) {
      const float4* row = gattr + 4 * (size_t)gauss_id[start + b0 + tid];
#pragma unroll
      for (int q = 0; q < 4; ++q) s_attr[tid][q] = row[q];
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float4 a0 = s_attr[j][0];
      const float4 a1 = s_attr[j][1];
      const float4 a2 = s_attr[j][2];
      const float4 a3 = s_attr[j][3];
      float acc[kGrad];
#pragma unroll
      for (int c = 0; c < kGrad; ++c) acc[c] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (T[k] < kTEps) continue;
        const float dx = px[k] - a0.x;
        const float dy = py[k] - a0.y;
        const float power =
            -0.5f * (a0.z * dx * dx + a1.x * dy * dy) - a0.w * dx * dy;
        if (power > 0.0f) continue;
        const float e = expf(power);
        const float alpha_raw = a1.y * e;
        const float alpha = fminf(kAlphaMax, alpha_raw);
        if (alpha < kAlphaMin) continue;
        const double s_new = S[k] + (double)log1pf(-alpha);
        const float t_new = expf((float)s_new);
        const float t_excl = T[k];
        const float m = (t_new >= kTEps) ? 1.0f : 0.0f;
        const float w = t_excl * alpha * m;
        const float chg = g[k][0] * a1.z + g[k][1] * a1.w + g[k][2] * a2.x +
                          g[k][3] * a2.y + g[k][4] * a2.z + g[k][5] * a2.w +
                          g[k][6] * a3.x + g[k][7] * a3.y + g[k][8];
        prefix[k] += w * chg;
        const float s_rest = (g_tot[k] - prefix[k]) + s_base[k];
        const float d_alpha = t_excl * m * chg - s_rest / (1.0f - alpha);
        if (alpha_raw < kAlphaMax) {
          const float d_power = d_alpha * alpha;
          acc[0] += d_power * (a0.z * dx + a0.w * dy);
          acc[1] += d_power * (a1.x * dy + a0.w * dx);
          acc[2] += -0.5f * dx * dx * d_power;
          acc[3] += -(dx * dy) * d_power;
          acc[4] += -0.5f * dy * dy * d_power;
          acc[5] += d_alpha * e;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[6 + c] += g[k][c] * w;
        S[k] = s_new;
        T[k] = t_new;
        touched = true;
      }
      if (__any_sync(kFull, touched)) {
#pragma unroll
        for (int c = 0; c < kGrad; ++c) {
          float v = acc[c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
          acc[c] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kGrad; ++c) s_part[j][warp][c] = acc[c];
      }
    }

    int live = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= (T[k] >= kTEps);
    const int n_live = __syncthreads_count(live);  // also orders s_part
    for (int e = tid; e < n * kRow; e += kThreads) {
      const int j = e / kRow;
      const int c = e % kRow;
      float v = 0.0f;
      if (c < kGrad) {
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) v += s_part[j][wi][c];
      }
      rows[(size_t)(start + b0 + j) * kRow + c] = v;
    }
    if (n_live == 0) break;
  }
}

__global__ void fold_rows_kernel(const float* __restrict__ rows_exp,
                                 const int* __restrict__ g_start,
                                 int num_gaussians,
                                 float* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)num_gaussians * kRow) return;
  const size_t gi = idx / kRow;
  const int c = (int)(idx % kRow);
  const int s = g_start[gi];
  const int e = g_start[gi + 1];
  float acc = 0.0f;
  for (int j = s; j < e; ++j) acc += rows_exp[(size_t)j * kRow + c];
  out[idx] = acc;
}

}  // namespace

// C entry points, loaded with ctypes. Both launch on `stream` and return
// cudaGetLastError() (0 on success).
//
// hidegs_blend_bwd — gattr: (N, 16) float32 packed rows; gauss_id: (I,)
// int32 sorted instance → gaussian; tile_start, tile_count: (num_tiles,)
// int32 spans (count 0 for tiles not blended); g_aug: (num_tiles, tile²,
// 16) float32 augmented cotangents; rows: (I, 16) float32, zero-filled by
// the caller, one gradient row per sorted instance.
extern "C" int hidegs_blend_bwd(const void* gattr, const void* gauss_id,
                                const void* tile_start, const void* tile_count,
                                int num_tiles, int tiles_x, int tile,
                                const void* g_aug, void* rows, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a = static_cast<const float4*>(gattr);
  const int* gid = static_cast<const int*>(gauss_id);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  const float4* g = static_cast<const float4*>(g_aug);
  float* r = static_cast<float*>(rows);
  if (tile == 16) {
    blend_bwd_kernel<16><<<num_tiles, kThreads, 0, s>>>(a, gid, ts, tc, tiles_x, g, r);
  } else if (tile == 32) {
    blend_bwd_kernel<32><<<num_tiles, kThreads, 0, s>>>(a, gid, ts, tc, tiles_x, g, r);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// hidegs_fold_rows — rows_exp: (I, 16) float32 rows in expansion order;
// g_start: (N + 1,) int32 first expansion slot of each gaussian (the last
// entry is the expansion total), clamped to I; out: (N, 16) float32.
extern "C" int hidegs_fold_rows(const void* rows_exp, const void* g_start,
                                int num_gaussians, void* out, void* stream) {
  if (num_gaussians <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)num_gaussians * kRow;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fold_rows_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(rows_exp), static_cast<const int*>(g_start),
      num_gaussians, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
