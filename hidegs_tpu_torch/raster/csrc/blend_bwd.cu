// Backward tile blend for NVIDIA Hopper (sm_90a), written by hand, and the
// fold of its per-instance gradient rows into per-gaussian rows.
//
// blend_bwd_kernel replaces hidegs_tpu/raster/pallas_vjp.py:_passB_kernel
// (launched by blend_tiles_pallas_bwd). Same function, not the same layout:
// the TPU kernel walks a sequential grid of 128-instance blocks with VMEM
// carries and writes an (ATTR, block) tile tagged with float32 gaussian ids;
// here one CTA owns one tile and walks its whole span, as blend_fwd.cu does.
//
//   * 256 threads own the tile's pixels in the forward kernel's compact warp
//     footprints (blend_common.cuh). Per pixel, in registers: the
//     log-transmittance carry (float64, rounded to float32 before each exp,
//     exactly as blend_fwd.cu does it), T and the running prefix Σ w·chg
//     (float64, as the plain version's cumsum; see the note on rounding
//     below); in shared memory, read back by the pixel's own thread: the
//     cotangents g[0:9], G_total and T_final·g_T (channels 10 and 11 of the
//     augmented cotangent planes). Holding those 44 values per thread in
//     registers took 149 registers and one CTA per SM; in shared memory the
//     kernel fits three CTAs per SM in 80 registers, spilling a few bytes at
//     tile 32 (at two CTAs it needs 113 registers, spills nothing and ran
//     12% slower on the H100).
//   * Batches of 48 instances are gathered through gauss_id into shared
//     memory, with each instance's warp-block mask and expansion slot beside
//     its row, as in the forward: a warp evaluates only the blocks an
//     instance can reach. Per pixel and instance, front to back:
//       α, keep, T_excl, T_incl as in the forward kernel
//       w      = T_excl·α·m,  m = [T_incl ≥ 1e-4]
//       chg    = Σ_c g_c·channel_c  (rgb, invdepth, normal, distance, 1)
//       prefix += w·chg;  S = G_total − prefix + T_final·g_T
//       dα     = T_excl·m·chg − S/(1−α)
//       dpower = dα·α and dop = dα·exp(power), where α_raw < 0.99
//     and from these the 14 gradient values of the instance's packed row:
//     d_mean2d (2), d_conic (3), d_opacity, and Σ g_c·w for the 8 channels.
//     A pixel whose T fell below 1e-4 is done; a warp whose pixels are all
//     done skips the rest of the span; the CTA stops once every pixel is
//     done.
//   * Reduction over the tile's pixels, in a fixed order: each thread sums
//     its own pixels, a warp where some lane touched the instance sums its
//     lanes with one reduce-scatter butterfly over 16 slots (the 14 values
//     and two zero pads: 8+4+2+1+1 = 16 shuffles, after which lanes 2s and
//     2s+1 hold the warp's sum of slot s), and the per-warp partials
//     (shared memory; zero from a warp that skipped the instance) are summed
//     in warp order. One row per instance is written, at the instance's
//     expansion slot slot_s[k], so that each gaussian's rows lie contiguous
//     for the fold; slot_s is a permutation, so no two instances share a
//     row, and there are no atomics. Instances after the CTA stops keep the
//     zero rows the wrapper allocated.
//
// fold_rows_kernel sums those expansion-order rows over each gaussian's span
// [g_start[g], g_start[g+1]) in slot order. It takes the place of the
// segment sum of pallas_vjp.py:455 and of a float index_add_, whose atomics
// would make gradients differ from run to run. What bounds it is bytes: each
// 64-byte row is read once and each 64-byte gaussian row written once, and
// at full width most gaussians have no instance at all (an empty span costs
// its output row and nothing else). So four lanes own one gaussian, one
// float4 of its row each (a warp covers 8 gaussians), read the rows with
// 16-byte non-coherent loads and write one 16-byte store; a warp reads the 9
// span bounds of its 8 gaussians once and passes them on with shuffles.
// Each column
// still adds its span's rows one by one in slot order with float32 adds
// (no fma: there is nothing to fuse), which is the plain version's order
// (blend_plain.fold_rows), so the two agree to the bit.
//
// What bounds the backward: the per-(pixel, instance) arithmetic, as in the
// forward. Each evaluated pair costs the forward's ~16 ops and one exp; each
// kept pair adds a log1p, an exp, one more exp for dop and ~60 ops (chg,
// the prefix, dα and the 14 gradient terms). The mask leaves about a quarter
// of the whole-tile pairs to evaluate, and the reduction costs 16 shuffles
// per instance and touched warp. Bytes (a 64-byte row per instance in and
// out, 64 bytes of cotangents per pixel) are small beside that.
//
// bf16 mode (BF16 = true, `hidegs_blend_bwd_bf16`): the rows are the
// 32-byte bf16 rows of blend_common.cuh, widened and re-based to the tile by
// load_row, with tile-local pixel centres, as in blend_fwd.cu. The gradient
// rows stay float32 in the float32 layout (the rounding's gradient is the
// identity, as in JAX), so the fold is the same either way.
//
// Built with -fmad=false and without --use_fast_math, like blend_fwd.cu, so
// α, T and the cutoffs are bitwise the forward kernel's. Rounding of the
// gradient terms: dα = T_excl·m·chg − S/(1−α) cancels, often by orders of
// magnitude, so chg, the prefix and dα round as the plain version's do
// (chg left to right with every product rounded, each w·chg rounded to
// float32 and summed in float64). With a float32 prefix or an fmaf in chg or
// dα, a few full-width gradients on the H100 missed the plain version's by
// up to 4.5e-2 x their column's median |grad|; rounded as here, by at most
// 1.1e-4 x. The 14 sums only accumulate, so they use explicit fmaf.

#include "blend_common.cuh"

namespace {

using namespace hidegs;

constexpr int kBatch = 48;  // instances staged per shared-memory batch
constexpr int kRow = 16;    // floats per packed row
constexpr int kGrad = 14;   // gradient values per row (the rest is padding)

// Reduce-scatter of v[16] over the warp: returns the warp's sum of slot
// lane / 2. Each step keeps the half of the slots that the lane's bit
// selects and adds the partner's copy of it; the order is fixed, so the
// result is bitwise reproducible. v is clobbered.
__device__ __forceinline__ float warp_reduce_scatter16(float (&v)[kRow], int lane) {
#pragma unroll
  for (int half = 8, off = 16; half >= 1; half >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// Augmented cotangent row per pixel, 16 floats = 4 float4:
//   g[0:10] (rgb, invdepth, normal, distance, acc_alpha, T_final),
//   [10] G_total, [11] T_final·g_T, [12:16] unused.
// Of those the kernel keeps kCot values per pixel in shared memory,
// [c][k][thread]: g[0:9], G_total and T_final·g_T.
constexpr int kCot = 11;

// Dynamic shared memory of blend_bwd_kernel<TILE>, in this order: the
// staged rows (float4 [kBatch][4]), the cotangents (float [kCot][P]), the
// per-warp partials (float [kBatch][kWarps][kGrad]), the masks and the
// expansion slots of the staged instances.
template <int TILE>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float4) * kBatch * 4 + sizeof(float) * kCot * TileLayout<TILE>::P +
         sizeof(float) * kBatch * kWarps * kGrad + sizeof(unsigned) * kBatch + sizeof(int) * kBatch;
}

template <int TILE, bool BF16>
__global__ void __launch_bounds__(kThreads, 3)
blend_bwd_kernel(const void* __restrict__ gattr,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count,
                 int tiles_x,
                 const int* __restrict__ slot_s,
                 const float4* __restrict__ g_aug,
                 float* __restrict__ rows) {
  using L = TileLayout<TILE>;
  constexpr int PPT = L::PPT;
  constexpr int P = L::P;
  static_assert(kBatch <= kThreads, "one staged row per thread");

  extern __shared__ float4 s_dyn[];
  float4 (*s_attr)[4] = reinterpret_cast<float4 (*)[4]>(s_dyn);
  float* s_cot = reinterpret_cast<float*>(s_dyn + kBatch * 4);
  float (*s_part)[kWarps][kGrad] = reinterpret_cast<float (*)[kWarps][kGrad]>(s_cot + kCot * P);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_part + kBatch);
  int* s_slot = reinterpret_cast<int*>(s_mask + kBatch);

  const int t = blockIdx.x;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ox = (t % tiles_x) * TILE;
  const int oy = (t / tiles_x) * TILE;
  const int pox = BF16 ? 0 : ox;  // pixel origin, as in blend_fwd.cu
  const int poy = BF16 ? 0 : oy;
  const int slot = lane >> 1;  // the slot this lane holds after the reduction
  const bool writes_slot = !(lane & 1) && slot < kGrad;

  // this lane's pixel in the warp's first block, as in blend_fwd.cu
  const int x0 = L::block_x0(warp * PPT) + (lane & (kBlockW - 1));
  const int y0 = L::block_y0(warp * PPT) + lane / kBlockW;
  const float px0 = pixel_centre(x0, pox);
  const float py0 = pixel_centre(y0, poy);
  float T[PPT];
  double S[PPT], prefix[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    S[k] = 0.0;
    T[k] = 1.0f;
    prefix[k] = 0.0;
    const float4* gr = g_aug + 4 * ((size_t)t * P + (y0 + L::k_dy(k)) * TILE + x0 + L::k_dx(k));
    const float4 q0 = gr[0], q1 = gr[1], q2 = gr[2];
    float* cot = s_cot + k * kThreads + tid;  // read back by this thread only
    cot[0 * P] = q0.x; cot[1 * P] = q0.y; cot[2 * P] = q0.z; cot[3 * P] = q0.w;
    cot[4 * P] = q1.x; cot[5 * P] = q1.y; cot[6 * P] = q1.z; cot[7 * P] = q1.w;
    cot[8 * P] = q2.x; cot[9 * P] = q2.z; cot[10 * P] = q2.w;
  }
  bool warp_live = true;  // warp-uniform: some pixel of the warp has T ≥ 1e-4

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int n = min(kBatch, count - b0);
    __syncthreads();  // the previous batch is fully consumed
    if (tid < n) {
      float4 row[4];
      load_row<BF16>(gattr, gauss_id[start + b0 + tid], ox, oy, row);
#pragma unroll
      for (int q = 0; q < 4; ++q) s_attr[tid][q] = row[q];
      s_slot[tid] = slot_s[start + b0 + tid];
    }
    __syncthreads();
    stage_masks<TILE>(s_attr, s_mask, n, pox, poy);
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const unsigned bits = warp_live ? L::warp_bits(s_mask[j], warp) : 0u;
      float part = 0.0f;
      if (bits) {
        const float4 a0 = s_attr[j][0];
        const float4 a1 = s_attr[j][1];
        const float4 a2 = s_attr[j][2];
        const float4 a3 = s_attr[j][3];
        float acc[kRow];
#pragma unroll
        for (int c = 0; c < kRow; ++c) acc[c] = 0.0f;
        bool touched = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!(bits & (1u << k)) || T[k] < kTEps) continue;
          float dx, dy;
          const float power = pixel_power(a0, a1, px0 + (float)L::k_dx(k), py0 + (float)L::k_dy(k), dx, dy);
          if (power > 0.0f) continue;
          const float e = expf(power);
          const float alpha_raw = a1.y * e;
          const float alpha = fminf(kAlphaMax, alpha_raw);
          if (alpha < kAlphaMin) continue;
          const float* cot = s_cot + k * kThreads + tid;
          const double s_new = S[k] + (double)log1pf(-alpha);
          const float t_new = expf((float)s_new);
          const float t_excl = T[k];
          const float m = (t_new >= kTEps) ? 1.0f : 0.0f;
          const float w = t_excl * alpha * m;
          const float chg = cot[0 * P] * a1.z + cot[1 * P] * a1.w + cot[2 * P] * a2.x +
                            cot[3 * P] * a2.y + cot[4 * P] * a2.z + cot[5 * P] * a2.w +
                            cot[6 * P] * a3.x + cot[7 * P] * a3.y + cot[8 * P];
          prefix[k] += (double)(w * chg);
          const float s_rest = (cot[9 * P] - (float)prefix[k]) + cot[10 * P];
          const float d_alpha = t_excl * m * chg - s_rest / (1.0f - alpha);
          if (alpha_raw < kAlphaMax) {
            const float d_power = d_alpha * alpha;
            acc[0] = fmaf(d_power, fmaf(a0.z, dx, a0.w * dy), acc[0]);
            acc[1] = fmaf(d_power, fmaf(a1.x, dy, a0.w * dx), acc[1]);
            acc[2] = fmaf(-0.5f * dx * dx, d_power, acc[2]);
            acc[3] = fmaf(-(dx * dy), d_power, acc[3]);
            acc[4] = fmaf(-0.5f * dy * dy, d_power, acc[4]);
            acc[5] = fmaf(d_alpha, e, acc[5]);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[6 + c] = fmaf(cot[c * P], w, acc[6 + c]);
          S[k] = s_new;
          T[k] = t_new;
          touched = true;
        }
        if (__any_sync(kFull, touched)) {
          part = warp_reduce_scatter16(acc, lane);
          bool live = false;
#pragma unroll
          for (int k = 0; k < PPT; ++k) live |= (T[k] >= kTEps);
          warp_live = __any_sync(kFull, live);
        }
      }
      if (writes_slot) s_part[j][warp][slot] = part;
    }

    const int n_live = __syncthreads_count(warp_live && lane == 0);  // also orders s_part
    // one float4 of a row per thread: columns 4q..4q+3 of staged instance
    // j, each summed over the warps in warp order, stored at its slot
    for (int e = tid; e < n * 4; e += kThreads) {
      const int j = e >> 2;
      const int q = e & 3;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * q + k;
        v[k] = 0.0f;
        if (c < kGrad) {
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi) v[k] += s_part[j][wi][c];
        }
      }
      reinterpret_cast<float4*>(rows)[(size_t)s_slot[j] * 4 + q] = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (n_live == 0) break;
  }
}

template <int TILE, bool BF16>
int launch_bwd(const void* a, const int* gid, const int* ts, const int* tc, int num_tiles,
               int tiles_x, const int* slot, const float4* g, float* r, cudaStream_t s) {
  constexpr size_t bytes = bwd_smem_bytes<TILE>();
  cudaError_t err = cudaFuncSetAttribute(blend_bwd_kernel<TILE, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_bwd_kernel<TILE, BF16><<<num_tiles, kThreads, bytes, s>>>(a, gid, ts, tc, tiles_x, slot, g, r);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch_bwd_tile(const void* gattr, const void* gauss_id, const void* tile_start,
                    const void* tile_count, int num_tiles, int tiles_x, int tile, const void* slot_s,
                    const void* g_aug, void* rows, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(gauss_id);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  const int* slot = static_cast<const int*>(slot_s);
  const float4* g = static_cast<const float4*>(g_aug);
  float* r = static_cast<float*>(rows);
  if (tile == 16) return launch_bwd<16, BF16>(gattr, gid, ts, tc, num_tiles, tiles_x, slot, g, r, s);
  if (tile == 32) return launch_bwd<32, BF16>(gattr, gid, ts, tc, num_tiles, tiles_x, slot, g, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kFoldLanes = 4;  // lanes per gaussian, one float4 of its row each
constexpr int kFoldPerWarp = 32 / kFoldLanes;

__device__ __forceinline__ void add4(float4& acc, const float4 r) {
  acc.x = __fadd_rn(acc.x, r.x);
  acc.y = __fadd_rn(acc.y, r.y);
  acc.z = __fadd_rn(acc.z, r.z);
  acc.w = __fadd_rn(acc.w, r.w);
}

__global__ void __launch_bounds__(kThreads)
fold_rows_kernel(const float4* __restrict__ rows_exp,
                 const int* __restrict__ g_start,
                 int num_gaussians,
                 float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int q = lane & (kFoldLanes - 1);  // this lane's float4 of the row
  const int sub = lane / kFoldLanes;      // this lane's gaussian in the warp's 8
  const int g0 = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5) * kFoldPerWarp;
  if (g0 >= num_gaussians) return;  // warp-uniform
  // lanes 0..8 read the 9 bounds of the warp's 8 spans (g_start has N+1)
  const int b = (lane <= kFoldPerWarp && g0 + lane <= num_gaussians) ? g_start[g0 + lane] : 0;
  const int s = __shfl_sync(kFull, b, sub);
  const int e = __shfl_sync(kFull, b, sub + 1);
  const int g = g0 + sub;
  if (g >= num_gaussians) return;  // only in the last group, after its shuffles
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* r = rows_exp + (size_t)s * kFoldLanes + q;  // __ldg: ld.global.nc.v4.f32
  int j = s;
  for (; j + 4 <= e; j += 4, r += 4 * kFoldLanes) {
    const float4 r0 = __ldg(r);
    const float4 r1 = __ldg(r + kFoldLanes);
    const float4 r2 = __ldg(r + 2 * kFoldLanes);
    const float4 r3 = __ldg(r + 3 * kFoldLanes);
    add4(acc, r0);
    add4(acc, r1);
    add4(acc, r2);
    add4(acc, r3);
  }
  for (; j < e; ++j, r += kFoldLanes) add4(acc, __ldg(r));
  out[(size_t)g * kFoldLanes + q] = acc;
}

}  // namespace

// C entry points, loaded with ctypes. Both launch on `stream` and return
// cudaGetLastError() (0 on success).
//
// hidegs_blend_bwd — gattr: (N, 16) float32 packed rows (or, for
// hidegs_blend_bwd_bf16, the (N, 8) 32-bit words of bf16 rows of
// blend_common.cuh; the arguments are otherwise the same); gauss_id: (I,)
// int32 sorted instance → gaussian; tile_start, tile_count: (num_tiles,)
// int32 spans (count 0 for tiles not blended); slot_s: (I,) int32 sorted
// instance → expansion slot, a permutation of [0, I); g_aug: (num_tiles,
// tile², 16) float32 augmented cotangents; rows: (I, 16) float32,
// zero-filled by the caller, one gradient row per instance in expansion
// order (row slot_s[k] for sorted instance k).
extern "C" int hidegs_blend_bwd(const void* gattr, const void* gauss_id,
                                const void* tile_start, const void* tile_count,
                                int num_tiles, int tiles_x, int tile,
                                const void* slot_s, const void* g_aug, void* rows, void* stream) {
  return launch_bwd_tile<false>(gattr, gauss_id, tile_start, tile_count, num_tiles, tiles_x, tile,
                                slot_s, g_aug, rows, stream);
}

extern "C" int hidegs_blend_bwd_bf16(const void* gattr, const void* gauss_id,
                                     const void* tile_start, const void* tile_count,
                                     int num_tiles, int tiles_x, int tile,
                                     const void* slot_s, const void* g_aug, void* rows, void* stream) {
  return launch_bwd_tile<true>(gattr, gauss_id, tile_start, tile_count, num_tiles, tiles_x, tile,
                               slot_s, g_aug, rows, stream);
}

// hidegs_fold_rows — rows_exp: (I, 16) float32 rows in expansion order;
// g_start: (N + 1,) int32 first expansion slot of each gaussian (the last
// entry is the expansion total), clamped to I; out: (N, 16) float32. One
// warp per group of 8 gaussians.
extern "C" int hidegs_fold_rows(const void* rows_exp, const void* g_start,
                                int num_gaussians, void* out, void* stream) {
  if (num_gaussians <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = ((long long)num_gaussians + kFoldPerWarp - 1) / kFoldPerWarp;
  const unsigned blocks = (unsigned)((groups + kWarps - 1) / kWarps);
  fold_rows_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float4*>(rows_exp), static_cast<const int*>(g_start),
      num_gaussians, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
