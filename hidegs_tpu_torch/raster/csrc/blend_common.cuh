// What the forward and backward tile-blend kernels (blend_fwd.cu,
// blend_bwd.cu) share: the packed-row layout and constants, the map from
// threads to pixels, and the warp-block mask. Both sources include this
// header, so a pixel's α, T and cutoffs come out bitwise the same in both.
//
// Packed gaussian row, 16 floats = 4 float4:
//   [0] mean_x mean_y conic_a conic_b   [1] conic_c opacity r g
//   [2] b invdepth normal_x normal_y    [3] normal_z distance pad pad
//
// Pixels and warps. A tile's pixels fall into 8x4 blocks, one pixel per lane
// (lane l: x = l % 8, y = l / 8 inside the block). Warp w owns PPT blocks:
// at tile 16 (PPT 1) block w; at tile 32 (PPT 4) blocks 4w..4w+3, a compact
// 16x8 region. A gaussian covers a compact region of the screen, so a warp
// of compact blocks meets few of them, where a warp of whole rows spread
// over the tile meets nearly every one.
//
// The warp-block mask. Bit b of an instance's mask says whether its
// α ≥ 1/255 level set can reach block b. The test is the binning's exact
// cull (raster/binning.py: _tile_min_quadratic, the min of the quadratic
// form over a box) applied to the box of the block's pixel centres:
//   keep iff q_min ≤ ln(op·255) + kMaskMargin + kMaskRelMargin·size
// where size bounds the magnitude of the quadratic's terms over the box.
// The mask must be conservative: a pair it skips must be one the kernels
// would reject (power > 0 or α < 1/255). The box edges are the kernels' own
// dx, dy of the block's edge pixels (the same float subtraction), so every
// pixel lies in the box; q_min and the kernels' `power` then differ only by
// rounding, a few ulp of `size` (kMaskRelMargin covers it even where a
// thin, near-singular conic makes the terms large and cancel), and exp/log
// rounding (kMaskMargin, the binning's margin, covers it). NaN keeps the
// block. blend_plain.block_masks is the plain version, op for op.

#pragma once

#include <cuda_runtime.h>

namespace hidegs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTEps = 1e-4f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockW = 8;
constexpr int kBlockH = 4;
constexpr float kMaskMargin = 1e-3f;
constexpr float kMaskRelMargin = 1e-6f;

template <int TILE>
struct TileLayout {
  static constexpr int P = TILE * TILE;
  static constexpr int PPT = P / kThreads;                 // pixels per thread = blocks per warp
  static constexpr int kBlocks = P / (kBlockW * kBlockH);  // bits of a mask
  static_assert(TILE == 16 || TILE == 32, "tile must be 16 or 32");
  static_assert(PPT * kWarps == kBlocks, "one pixel per lane per block");

  // tile-local pixel offsets of block b's top-left pixel
  __device__ static __forceinline__ int block_x0(int b) {
    if (TILE == 16) return (b & 1) * kBlockW;
    return ((b >> 2) & 1) * 16 + (b & 1) * kBlockW;
  }
  __device__ static __forceinline__ int block_y0(int b) {
    if (TILE == 16) return (b >> 1) * kBlockH;
    return (b >> 3) * 8 + ((b >> 1) & 1) * kBlockH;
  }
  // offset of a warp's k-th block from its first one (0 ≤ k < PPT)
  __host__ __device__ static constexpr int k_dx(int k) { return (k & 1) * kBlockW; }
  __host__ __device__ static constexpr int k_dy(int k) { return (k >> 1) * kBlockH; }
  // the bits of a mask that belong to warp w's blocks
  __device__ static __forceinline__ unsigned warp_bits(unsigned mask, int w) {
    return (mask >> (w * PPT)) & ((1u << PPT) - 1u);
  }
};

// Centre of the pixel at tile-local (x, y) of the tile with pixel origin
// (ox, oy): (x + 0.5 + ox, y + 0.5 + oy), exact in float32.
__device__ __forceinline__ float pixel_centre(int local, int origin) {
  return (float)local + 0.5f + (float)origin;
}

// power = -½(a dx² + c dy²) - b dx dy of row (a0, a1) at pixel (px, py).
// The files are built with -fmad=false, so this rounds as the plain
// PyTorch version does.
__device__ __forceinline__ float pixel_power(float4 a0, float4 a1, float px, float py,
                                             float& dx, float& dy) {
  dx = px - a0.x;
  dy = py - a0.y;
  return -0.5f * (a0.z * dx * dx + a1.x * dy * dy) - a0.w * dx * dy;
}

// Can row (a0, a1)'s α ≥ 1/255 level set reach the 8x4 block whose top-left
// pixel centre is (px_lo, py_lo)? See the mask note above.
__device__ __forceinline__ bool block_reachable(float4 a0, float4 a1, float px_lo, float py_lo) {
  const float ca = a0.z, cb = a0.w, cc = a1.x;
  const float lo_x = px_lo - a0.x, hi_x = (px_lo + (float)(kBlockW - 1)) - a0.x;
  const float lo_y = py_lo - a0.y, hi_y = (py_lo + (float)(kBlockH - 1)) - a0.y;
  const float cc_c = fmaxf(cc, 1e-12f), ca_c = fmaxf(ca, 1e-12f);
  // edges at dx = lo_x, hi_x (dy free in [lo_y, hi_y]) and dy = lo_y, hi_y
  const float dy0 = fminf(fmaxf(-cb * lo_x / cc_c, lo_y), hi_y);
  const float dy1 = fminf(fmaxf(-cb * hi_x / cc_c, lo_y), hi_y);
  const float dx0 = fminf(fmaxf(-cb * lo_y / ca_c, lo_x), hi_x);
  const float dx1 = fminf(fmaxf(-cb * hi_y / ca_c, lo_x), hi_x);
  const float q0 = 0.5f * (ca * lo_x * lo_x + cc * dy0 * dy0) + cb * lo_x * dy0;
  const float q1 = 0.5f * (ca * hi_x * hi_x + cc * dy1 * dy1) + cb * hi_x * dy1;
  const float q2 = 0.5f * (ca * dx0 * dx0 + cc * lo_y * lo_y) + cb * dx0 * lo_y;
  const float q3 = 0.5f * (ca * dx1 * dx1 + cc * hi_y * hi_y) + cb * dx1 * hi_y;
  float q_min = fminf(fminf(q0, q1), fminf(q2, q3));
  if (lo_x <= 0.0f && hi_x >= 0.0f && lo_y <= 0.0f && hi_y >= 0.0f) q_min = 0.0f;
  const float mx = fmaxf(fabsf(lo_x), fabsf(hi_x));
  const float my = fmaxf(fabsf(lo_y), fabsf(hi_y));
  const float size = 0.5f * (fabsf(ca) * mx * mx + fabsf(cc) * my * my) + fabsf(cb) * mx * my;
  const float budget = logf(fmaxf(a1.y, 1e-12f) * 255.0f) + kMaskMargin + kMaskRelMargin * size;
  return !(q_min > budget);
}

// The masks of the n staged rows s_attr[0:n] into s_mask[0:n]: one
// (instance, block) test per thread, gathered into 32-bit masks with one
// ballot per warp. Called by the whole CTA between two barriers.
template <int TILE>
__device__ __forceinline__ void stage_masks(const float4 (*s_attr)[4], unsigned* s_mask, int n,
                                            int ox, int oy) {
  using L = TileLayout<TILE>;
  const int lane = threadIdx.x & 31;
  const int total = n * L::kBlocks;
  for (int e0 = (threadIdx.x & ~31); e0 < total; e0 += kThreads) {
    const int e = e0 + lane;
    bool reach = false;
    if (e < total) {
      const int j = e / L::kBlocks;
      const int b = e % L::kBlocks;
      reach = block_reachable(s_attr[j][0], s_attr[j][1], pixel_centre(L::block_x0(b), ox),
                              pixel_centre(L::block_y0(b), oy));
    }
    const unsigned ballot = __ballot_sync(kFull, reach);
    if (L::kBlocks == 32) {
      if (lane == 0) s_mask[e0 / 32] = ballot;
    } else if (lane % L::kBlocks == 0 && e < total) {
      s_mask[e / L::kBlocks] = (ballot >> lane) & ((1u << (L::kBlocks & 31)) - 1u);
    }
  }
}

}  // namespace hidegs
