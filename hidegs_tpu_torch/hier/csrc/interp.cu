// The LOD cut's interpolation, one launch forward and one backward.
//
// No TPU kernel: the JAX package's hidegs_tpu/hier/interp.py:interpolate_cut
// is a chain of jnp gathers and lerps that XLA fuses, and its backward is
// jax.vjp of them. In PyTorch the same expression
// (hier/interp_autograd.py:interpolate_plain, the CPU path and these
// kernels' reference) gathers the child and parent rows of every budget
// slot into two (B, 59) matrices and reads each through five column slices;
// autograd's backward of each slice allocates a zeroed (B, 59) matrix and
// adds the five up. At the post-opt cell's B = 2^21 slots that is ten fills
// and eight adds of 495 MB a step, beside strided lerps. Here:
//
//   * a block takes THREADS slots. First one thread a slot reads the slot's
//     row indices, t, kids and valid flag and the quaternion and opacity
//     columns of its child's and its parent's row, and works out what the
//     whole slot shares: the rotation's sign and, forward, the corrected
//     opacity or, backward, the opacity column's two gradients. They go to
//     shared memory. Then the block's threads walk the tile's slots x 59
//     floats, neighbouring threads on neighbouring columns of one row, so
//     consecutive lanes read a row's 236 bytes (rows are 4-byte aligned
//     only: no vector loads);
//   * interp_fwd_kernel reads the rows straight from the packed (P, 59)
//     matrix at ri and pi, so neither gathered matrix exists, and writes
//     the five contiguous outputs of interpolate_cut (means, scales, quats,
//     opacity, SH), each float once;
//   * interp_bwd_kernel reads the five output gradients and writes the
//     child's and the parent's (B, 59) gradient rows once each, contiguous
//     across the tile. Their sums onto the P rows stay PyTorch's sorted
//     index_put_ (hier/interp_autograd.py:accumulate_rows), as autograd of
//     the gathers makes them, so the gradients into the packed matrix are
//     autograd's of the plain expression. No atomics.
//
// The arithmetic is the plain expression's, op by op in its order, each op
// rounded alone (the _rn intrinsics; built with -fmad=false as the blend
// kernels are):
//   lerp       t·c + (1 − t)·p
//   rotation   t·c + ((1 − t)·p)·sign, sign = −1 where Σ c·p < 0, the sum
//              in the order of PyTorch's CUDA reduction (quat_sign)
//   opacity    a = t·c + (1 − t)·p;  w = max(1 − a, 1e-8);
//              t·a + (1 − t)·(1 − w^(1/max(kids, 1))), 0 off the valid mask
// and the backward is autograd's of it: a product passes g times the other
// factor; pow passes g·(e·w^(e − 1)); maximum half the gradient at a tie
// and none below the clamp; where none off the mask; each gradient reached
// by two paths is their sum. Autograd sums a gathered row's gradient over
// its five column slices, zeros outside each, which turns a −0 into +0: the
// backward adds +0 to every float it writes to match. pow is CUDA's powf,
// which torch.pow calls for float32; built with these flags it rounds as
// PyTorch's does (H100, torch 2.11, CUDA 12.8: tests/test_torch_interp_cuda.py
// holds every output and gradient bitwise, the opacity's too).
//
// Bound on this card: bytes, a few flops a float. The least the forward
// needs: each distinct row of ri and pi read once (236 B), and per slot ri
// and pi (16 B), t, kids, valid (9 B) read and 236 B written. A slot whose
// parent or padding row no cache holds any more reads two rows: 733 B a
// slot, 1.54 GB at 2^21 slots, 0.46 ms at 3.35 TB/s. Backward: per slot
// the output gradients (236 B) and the slot's inputs (25 B) read and 472 B
// written, and the quaternion and opacity columns (20 B) of each distinct
// row read. chip_smoke.py:interp_bytes counts both on a cut.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // slots a block, and its threads
// hier/interp.py:pack_attributes' columns: means 0:3, scales 3:6, quats 6:10, opacity 10, SH 11:
constexpr int SCALE = 3, QUAT = 6, OPAC = 10, SH0 = 11;
constexpr float ALPHA_FLOOR = 1e-8f;  // hier/lod.py:hierarchy_opacity_correction's clamp

struct Slot {
  long long c, p;  // the child's and the parent's row offsets in attrs
  float t, omt, sign;
  float gc, gp;  // backward: the opacity column's gradients
};

__device__ __forceinline__ float lerp(float t, float omt, float c, float p) {
  return __fadd_rn(__fmul_rn(t, c), __fmul_rn(omt, p));
}

// torch.maximum: a NaN passes through
__device__ __forceinline__ float torch_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// where(Σ c·p < 0, −1, 1) over the quaternion columns. torch.sum of a
// (B, 4) product over its last dim gives each row four lanes of one warp,
// one product a lane, folded by shuffles at offsets 2 then 1:
// (x0 + x2) + (x1 + x3). The sign can hang on that order where the sum
// cancels.
__device__ __forceinline__ float quat_sign(const float* c, const float* p) {
  const float x0 = __fmul_rn(c[QUAT], p[QUAT]), x1 = __fmul_rn(c[QUAT + 1], p[QUAT + 1]);
  const float x2 = __fmul_rn(c[QUAT + 2], p[QUAT + 2]), x3 = __fmul_rn(c[QUAT + 3], p[QUAT + 3]);
  return __fadd_rn(__fadd_rn(x0, x2), __fadd_rn(x1, x3)) < 0.0f ? -1.0f : 1.0f;
}

// 1 / max(kids, 1) as float32
__device__ __forceinline__ float inv_kids(int kids) {
  return __fdiv_rn(1.0f, torch_max(__int2float_rn(kids), 1.0f));
}

// The slot pass: slot b's shared scalars into `s`, its child's and parent's
// opacities into `ac` and `ap`.
__device__ __forceinline__ void load_slot(const float* __restrict__ attrs, const int64_t* __restrict__ ri,
                                          const int64_t* __restrict__ pi, const float* __restrict__ ts, long long b,
                                          int W, Slot& s, float& ac, float& ap) {
  s.c = ri[b] * W;
  s.p = pi[b] * W;
  s.t = ts[b];
  s.omt = __fsub_rn(1.0f, s.t);
  const float* c = attrs + s.c;
  const float* p = attrs + s.p;
  s.sign = quat_sign(c, p);
  ac = c[OPAC];
  ap = p[OPAC];
}

__global__ void __launch_bounds__(THREADS) interp_fwd_kernel(
    const float* __restrict__ attrs, const int64_t* __restrict__ ri, const int64_t* __restrict__ pi,
    const float* __restrict__ ts, const int* __restrict__ kids, const uint8_t* __restrict__ valid, int B, int W,
    float* __restrict__ means, float* __restrict__ scales, float* __restrict__ quats, float* __restrict__ opac,
    float* __restrict__ sh) {
  __shared__ Slot slot[THREADS];
  const long long s0 = (long long)blockIdx.x * THREADS;
  const int n = (int)min((long long)THREADS, B - s0);
  if (threadIdx.x < n) {
    const long long b = s0 + threadIdx.x;
    Slot& s = slot[threadIdx.x];
    float ac, ap;
    load_slot(attrs, ri, pi, ts, b, W, s, ac, ap);
    const float a = lerp(s.t, s.omt, ac, ap);
    const float w = torch_max(__fsub_rn(1.0f, a), ALPHA_FLOOR);
    const float merged = __fsub_rn(1.0f, powf(w, inv_kids(kids[b])));
    opac[b] = valid[b] ? lerp(s.t, s.omt, a, merged) : 0.0f;
  }
  __syncthreads();
  const int shw = W - SH0, dk = THREADS / W, dj = THREADS - dk * W;
  int k = threadIdx.x / W, j = threadIdx.x - k * W;
  for (int e = threadIdx.x; e < n * W; e += THREADS) {
    if (j != OPAC) {
      const Slot& s = slot[k];
      const float c = attrs[s.c + j], p = attrs[s.p + j];
      const long long b = s0 + k;
      if (j < SCALE) {
        means[b * 3 + j] = lerp(s.t, s.omt, c, p);
      } else if (j < QUAT) {
        scales[b * 3 + j - SCALE] = lerp(s.t, s.omt, c, p);
      } else if (j < OPAC) {
        quats[b * 4 + j - QUAT] = __fadd_rn(__fmul_rn(s.t, c), __fmul_rn(__fmul_rn(s.omt, p), s.sign));
      } else {
        sh[b * shw + j - SH0] = lerp(s.t, s.omt, c, p);
      }
    }
    j += dj;
    k += dk;
    if (j >= W) j -= W, ++k;
  }
}

__global__ void __launch_bounds__(THREADS) interp_bwd_kernel(
    const float* __restrict__ attrs, const int64_t* __restrict__ ri, const int64_t* __restrict__ pi,
    const float* __restrict__ ts, const int* __restrict__ kids, const uint8_t* __restrict__ valid,
    const float* __restrict__ g_means, const float* __restrict__ g_scales, const float* __restrict__ g_quats,
    const float* __restrict__ g_opac, const float* __restrict__ g_sh, int B, int W, float* __restrict__ grad_c,
    float* __restrict__ grad_p) {
  __shared__ Slot slot[THREADS];
  const long long s0 = (long long)blockIdx.x * THREADS;
  const int n = (int)min((long long)THREADS, B - s0);
  if (threadIdx.x < n) {
    const long long b = s0 + threadIdx.x;
    Slot& s = slot[threadIdx.x];
    float ac, ap;
    load_slot(attrs, ri, pi, ts, b, W, s, ac, ap);
    const float g = valid[b] ? g_opac[b] : 0.0f;
    const float a = lerp(s.t, s.omt, ac, ap);
    const float e = inv_kids(kids[b]);
    const float u = __fsub_rn(1.0f, a);
    const float w = torch_max(u, ALPHA_FLOOR);
    const float g_pow = -__fmul_rn(g, s.omt);  // through 1 − pow and the product by (1 − t)
    const float g_w = e == 0.0f ? 0.0f : __fmul_rn(g_pow, __fmul_rn(e, powf(w, __fsub_rn(e, 1.0f))));
    const float g_u = u < ALPHA_FLOOR ? 0.0f : (u == ALPHA_FLOOR ? __fdiv_rn(g_w, 2.0f) : g_w);
    const float g_a = __fadd_rn(__fmul_rn(g, s.t), -g_u);  // t·a's path and (1 − a)'s
    s.gc = __fmul_rn(g_a, s.t);
    s.gp = __fmul_rn(g_a, s.omt);
  }
  __syncthreads();
  const int shw = W - SH0, dk = THREADS / W, dj = THREADS - dk * W;
  float* __restrict__ out_c = grad_c + s0 * W;
  float* __restrict__ out_p = grad_p + s0 * W;
  int k = threadIdx.x / W, j = threadIdx.x - k * W;
  for (int e = threadIdx.x; e < n * W; e += THREADS) {
    const Slot& s = slot[k];
    float gc, gp;
    if (j == OPAC) {
      gc = s.gc, gp = s.gp;
    } else {
      const long long b = s0 + k;
      float g;
      if (j < SCALE) {
        g = g_means[b * 3 + j];
      } else if (j < QUAT) {
        g = g_scales[b * 3 + j - SCALE];
      } else if (j < OPAC) {
        g = g_quats[b * 4 + j - QUAT];
      } else {
        g = g_sh[b * shw + j - SH0];
      }
      gc = __fmul_rn(g, s.t);
      gp = __fmul_rn(j >= QUAT && j < OPAC ? __fmul_rn(g, s.sign) : g, s.omt);
    }
    out_c[e] = __fadd_rn(gc, 0.0f);
    out_p[e] = __fadd_rn(gp, 0.0f);
    j += dj;
    k += dk;
    if (j >= W) j -= W, ++k;
  }
}

bool bad_shape(int B, int W) { return B < 0 || W <= SH0 || W > THREADS; }

}  // namespace

// attrs (P, W) float32, W = 11 + the SH floats a row; ri, pi (B,) int64 rows
// of attrs; ts (B,) float32; kids (B,) int32; valid (B,) bool. Writes means
// (B, 3), scales (B, 3), quats (B, 4), opac (B,) and sh (B, W - 11).
extern "C" int hidegs_interp_fwd(const float* attrs, const int64_t* ri, const int64_t* pi, const float* ts,
                                 const int* kids, const uint8_t* valid, int B, int W, float* means, float* scales,
                                 float* quats, float* opac, float* sh, cudaStream_t stream) {
  if (bad_shape(B, W)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  interp_fwd_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(attrs, ri, pi, ts, kids, valid, B, W,
                                                                         means, scales, quats, opac, sh);
  return (int)cudaGetLastError();
}

// The forward's inputs, then the gradients of its five outputs, contiguous
// and shaped as they are; writes grad_c and grad_p (B, W), the gradients at
// the child's and the parent's gathered rows.
extern "C" int hidegs_interp_bwd(const float* attrs, const int64_t* ri, const int64_t* pi, const float* ts,
                                 const int* kids, const uint8_t* valid, const float* g_means, const float* g_scales,
                                 const float* g_quats, const float* g_opac, const float* g_sh, int B, int W,
                                 float* grad_c, float* grad_p, cudaStream_t stream) {
  if (bad_shape(B, W)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  interp_bwd_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      attrs, ri, pi, ts, kids, valid, g_means, g_scales, g_quats, g_opac, g_sh, B, W, grad_c, grad_p);
  return (int)cudaGetLastError();
}
