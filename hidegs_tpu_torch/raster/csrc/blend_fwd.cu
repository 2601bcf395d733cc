// Forward tile blend for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces hidegs_tpu/raster/pallas_blend.py:_forward_kernel (launched by
// blend_tiles_pallas_fwd). Same function, not the same layout: the TPU
// kernel walks a sequential grid of 128-instance blocks with a VMEM carry,
// window tables and a lane-rolled DMA window; here blocks run in parallel,
// so each CTA owns one tile and walks that tile's whole span of the
// (tile, depth)-sorted instance stream itself.
//
//   * 256 threads own the tile's pixels in compact warp footprints (see
//     blend_common.cuh): one 8x4 block per warp at tile 16, four (a 16x8
//     region) at tile 32, one pixel per lane per block. Transmittance (as a
//     running sum of log(1-α)) and the nine accumulators live in registers.
//     The sum is carried in float64 and rounded to float32 before each exp,
//     as the plain version does with its float64 cumsum: a float32 carry
//     rounds differently and flipped the T_incl ≥ 1e-4 cutoff on a pixel at
//     full width.
//   * Batches of 256 instances are gathered through gauss_id into shared
//     memory (one 64-byte packed row each). The CTA then computes each
//     staged instance's warp-block mask (blend_common.cuh: the blocks its
//     α ≥ 1/255 level set can reach) and stores it beside the row. Per
//     instance a warp reads its bits of the mask as a broadcast and skips
//     the blocks whose bit is clear; the branch is warp-uniform. The mask
//     is conservative, so a skipped pair is one the pixel would have
//     rejected, and the result is bitwise what evaluating every pair gives.
//   * Per pixel of an evaluated block, front to back:
//       power = -0.5 (a dx² + c dy²) - b dx dy
//       α = min(0.99, op·exp(power)), kept iff power ≤ 0 and α ≥ 1/255
//       S += log1p(-α) (float64);  T = exp(float(S))
//       w = T_excl·α if T_incl ≥ 1e-4 else 0;  acc += w·(rgb, invd, n, dist, 1)
//     A pixel whose T fell below 1e-4 is done (its later w are all 0). A
//     warp whose pixels are all done skips the rest of the span but still
//     takes part in the CTA's barriers; the CTA stops once every pixel is
//     done (__syncthreads_count), the counterpart of the TPU kernel's
//     opaque-block skip.
//   * observe: per gaussian, the number of pixels with w > 0 and
//     T_excl > 0.5 over all its instances. Per staged instance the count is
//     summed with __ballot_sync/__popc per evaluated block and integer
//     shared-memory atomics across warps; at the end of the batch the thread
//     that staged the instance adds a nonzero count to its gaussian's int32
//     with one global integer atomicAdd. A gaussian has at most one instance
//     per tile, so those atomics fall on distinct rows within a CTA, and
//     integer adds commute, so the result is deterministic. Instances the
//     kernel never visits (padded or culled ones, which sort past every
//     tile's span, tiles past the block budget, instances after a CTA's
//     early stop) add nothing. No float atomics anywhere.
//   * Output: (T, P, 16) float32 tile planes, [0:3] rgb [3] invdepth
//     [4:7] normal [7] distance [8] acc_alpha [9] T_final [10:16] zero.
//     Tiles with no instances (the wrapper zeroes the count of tiles past
//     the block budget) get the background defaults: 0 with T_final = 1.
//
// What bounds it: the per-(pixel, instance) arithmetic. Every evaluated pair
// costs ~16 float ops and one exp; each kept pair adds a log1p, an exp and
// 18 ops of accumulation. The bytes (one 64-byte row per instance, 64 bytes
// out per pixel) are small beside that. At full width 84% of the (pixel,
// instance) pairs of a tile's span end in a rejection, and the mask leaves
// about a quarter of them to evaluate, for ~32 mask tests per instance.
//
// bf16 mode (BF16 = true, `hidegs_blend_fwd_bf16`): the rows are the
// 32-byte bf16 rows of blend_common.cuh; load_row widens them and re-bases
// mean2d to the tile, and the pixel centres are tile-local. The rest of the
// kernel is the same code.
//
// Math stays float32 with the accurate expf/log1pf (no --use_fast_math),
// apart from the float64 transmittance carry above.
// This file is built with -fmad=false: nvcc would otherwise contract
// `power` into FMAs, which rounds differently from the plain PyTorch
// version and can flip the power ≤ 0, α ≥ 1/255 and T_excl > 0.5 tests on
// boundary pixels, and with them out_observe.

#include "blend_common.cuh"

namespace {

using namespace hidegs;

constexpr int kBatch = 256;  // instances staged per shared-memory batch

template <int TILE, bool BF16>
__global__ void __launch_bounds__(kThreads, 3)
blend_fwd_kernel(const void* __restrict__ gattr,
                 const int* __restrict__ gauss_id,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_count,
                 int tiles_x,
                 float4* __restrict__ out,
                 int* __restrict__ observe) {
  using L = TileLayout<TILE>;
  constexpr int PPT = L::PPT;
  static_assert(kBatch == kThreads, "one staged row per thread");

  __shared__ float4 s_attr[kBatch][4];
  __shared__ unsigned s_mask[kBatch];
  __shared__ int s_obs[kBatch];

  const int t = blockIdx.x;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ox = (t % tiles_x) * TILE;
  const int oy = (t / tiles_x) * TILE;
  // pixel origin: the tile's, or 0 where the bf16 rows are tile-relative
  const int pox = BF16 ? 0 : ox;
  const int poy = BF16 ? 0 : oy;

  // this lane's pixel in the warp's first block; block k is offset by
  // (k_dx, k_dy), and the centres stay exact in float32
  const int x0 = L::block_x0(warp * PPT) + (lane & (kBlockW - 1));
  const int y0 = L::block_y0(warp * PPT) + lane / kBlockW;
  const float px0 = pixel_centre(x0, pox);
  const float py0 = pixel_centre(y0, poy);
  float T[PPT];
  double S[PPT];
  float acc[PPT][9];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    S[k] = 0.0;
    T[k] = 1.0f;
#pragma unroll
    for (int c = 0; c < 9; ++c) acc[k][c] = 0.0f;
  }
  bool warp_live = true;  // warp-uniform: some pixel of the warp has T ≥ 1e-4

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int n = min(kBatch, count - b0);
    __syncthreads();  // the previous batch is fully consumed
    int gid = 0;  // the gaussian of the instance this thread stages
    if (tid < n) {
      gid = gauss_id[start + b0 + tid];
      float4 row[4];
      load_row<BF16>(gattr, gid, ox, oy, row);
#pragma unroll
      for (int q = 0; q < 4; ++q) s_attr[tid][q] = row[q];
    }
    s_obs[tid] = 0;
    __syncthreads();
    stage_masks<TILE>(s_attr, s_mask, n, pox, poy);
    __syncthreads();

    for (int j = 0; warp_live && j < n; ++j) {
      const unsigned bits = L::warp_bits(s_mask[j], warp);
      if (bits == 0) continue;
      const float4 a0 = s_attr[j][0];
      const float4 a1 = s_attr[j][1];
      const float4 a2 = s_attr[j][2];
      const float4 a3 = s_attr[j][3];
      int cnt = 0;
      bool changed = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!(bits & (1u << k))) continue;
        bool fresh = false;
        if (T[k] >= kTEps) {
          float dx, dy;
          const float power = pixel_power(a0, a1, px0 + (float)L::k_dx(k), py0 + (float)L::k_dy(k), dx, dy);
          if (power <= 0.0f) {
            const float alpha = fminf(kAlphaMax, a1.y * expf(power));
            if (alpha >= kAlphaMin) {
              const double s_new = S[k] + (double)log1pf(-alpha);
              const float t_new = expf((float)s_new);
              if (t_new >= kTEps) {
                const float w = T[k] * alpha;
                acc[k][0] += w * a1.z;
                acc[k][1] += w * a1.w;
                acc[k][2] += w * a2.x;
                acc[k][3] += w * a2.y;
                acc[k][4] += w * a2.z;
                acc[k][5] += w * a2.w;
                acc[k][6] += w * a3.x;
                acc[k][7] += w * a3.y;
                acc[k][8] += w;
                fresh = T[k] > 0.5f;
              }
              S[k] = s_new;
              T[k] = t_new;
              changed = true;
            }
          }
        }
        cnt += __popc(__ballot_sync(kFull, fresh));
      }
      if (lane == 0 && cnt) atomicAdd(&s_obs[j], cnt);
      if (__any_sync(kFull, changed)) {
        bool live = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) live |= (T[k] >= kTEps);
        warp_live = __any_sync(kFull, live);
      }
    }

    const int n_live = __syncthreads_count(warp_live && lane == 0);  // also orders s_obs
    if (tid < n && s_obs[tid] != 0) atomicAdd(&observe[gid], s_obs[tid]);
    if (n_live == 0) break;
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float4* o = out + 4 * ((size_t)t * L::P + (y0 + L::k_dy(k)) * TILE + x0 + L::k_dx(k));
    o[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    o[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    o[2] = make_float4(acc[k][8], T[k], 0.0f, 0.0f);
    o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <bool BF16>
int launch_fwd(const void* gattr, const void* gauss_id, const void* tile_start, const void* tile_count,
               int num_tiles, int tiles_x, int tile, void* out, void* observe, void* stream) {
  if (num_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(gauss_id);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  float4* o = static_cast<float4*>(out);
  int* obs = static_cast<int*>(observe);
  if (tile == 16) {
    blend_fwd_kernel<16, BF16><<<num_tiles, kThreads, 0, s>>>(gattr, gid, ts, tc, tiles_x, o, obs);
  } else if (tile == 32) {
    blend_fwd_kernel<32, BF16><<<num_tiles, kThreads, 0, s>>>(gattr, gid, ts, tc, tiles_x, o, obs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, loaded with ctypes. gattr: (N, 16) float32 packed rows
// (hidegs_blend_fwd) or (N, 8) 32-bit words of bf16 rows
// (hidegs_blend_fwd_bf16, see blend_common.cuh); gauss_id: (I,) int32
// sorted instance → gaussian (every instance of a span < N); tile_start,
// tile_count: (num_tiles,) int32 spans; out: (num_tiles, tile², 16)
// float32; observe: (N,) int32 per-gaussian counts, zero-filled by the
// caller. Launch on `stream` and return
// cudaGetLastError() (0 on success).
extern "C" int hidegs_blend_fwd(const void* gattr, const void* gauss_id,
                                const void* tile_start, const void* tile_count,
                                int num_tiles, int tiles_x, int tile,
                                void* out, void* observe, void* stream) {
  return launch_fwd<false>(gattr, gauss_id, tile_start, tile_count, num_tiles, tiles_x, tile, out,
                           observe, stream);
}

extern "C" int hidegs_blend_fwd_bf16(const void* gattr, const void* gauss_id,
                                     const void* tile_start, const void* tile_count,
                                     int num_tiles, int tiles_x, int tile,
                                     void* out, void* observe, void* stream) {
  return launch_fwd<true>(gattr, gauss_id, tile_start, tile_count, num_tiles, tiles_x, tile, out,
                          observe, stream);
}
