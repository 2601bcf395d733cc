// The visibility-masked sparse Adam of the train and post-opt steps, one
// pass over every leaf of the parameters.
//
// No TPU kernel: the JAX package's hidegs_tpu/model/adam.py:masked_adam_update
// is a chain of jnp ops that XLA fuses into one loop per leaf. In PyTorch
// the same chain (model/adam.py:masked_adam_plain, the CPU path and this
// kernel's reference) is about 17 full-size ops a leaf, 128 launches a
// step, which stream every (rows, width) leaf through device memory some
// 43 times. Here each element is read and written once:
//
//   * one launch covers all leaves: the wrapper lays them end to end as
//     chunks of 4 floats (model/adam.py:leaf_table: each leaf's width, its
//     float count and the running end of its chunks); a thread takes one
//     chunk, finds its leaf by that table and the row of each float from
//     its flat index (one integer division a chunk);
//   * per row it reads the mask and the bias corrections c1 = 1 - b1^t and
//     c2 = 1 - b2^t (torch computes those (rows,) vectors, as the plain body
//     does); per float it reads p, g, m and v once and writes p, m and v
//     once, 16 bytes a thread, neighbouring threads on neighbouring
//     addresses. A gradient may be a column slice of a wider matrix (the
//     post-opt step's packed (rows, 59) gradient, the SH bands split out of
//     one (rows, 48) gradient): its rows are read at their own stride, a
//     float at a time. A chunk whose rows are all outside the mask reads no
//     gradient and copies p, m and v; where the outputs are the inputs (a
//     step that donates its state) it reads and writes nothing;
//   * the arithmetic is the plain body's, op by op in its order, each
//     rounded alone: m' = b1*m + (1-b1)*g, v' = b2*v + (1-b2)*(g*g),
//     p' = p - lr*(m'/c1) / (sqrt(v'/c2) + eps), with IEEE division and
//     square root, the constants as float32 as torch takes them from the
//     Python scalars, and the learning rate a float or read from a 0-d
//     device tensor (never read to the host, so the call captures). Rows
//     outside the mask keep their bits. So the result is bitwise the plain
//     body's on the card. Every thread writes only its own floats: no
//     atomics.
//
// Bound on this card: bytes. Per row of 59 floats (the hierarchy's and the
// trainer's leaves: 3+3+45+3+4+1) it reads 4 x 236 B and the row's mask
// and corrections (9 B) and writes 3 x 236 B: ~1,661 B, 3.36 GB at
// 2,020,479 rows, ~1.0 ms at 3.35 TB/s. Its few dozen instructions a float
// are far below the card's rate. Built with -fmad=false, as the blend
// kernels; the intrinsics below round each op alone whatever the flags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 8;
constexpr int PTRS = 8;   // per leaf: p, g, m, v, p_out, m_out, v_out, lr (null: the float lr)
constexpr int TABLE = 4;  // per leaf: width, floats, running end of its chunks, gradient row stride
constexpr int THREADS = 256;

struct Leaf {
  const float *p, *g, *m, *v;
  float *po, *mo, *vo;
  const float* lr_dev;
  float lr;
  int width, n, chunk_end, g_stride;
  bool vec;       // p, m, v and the outputs 16-byte aligned: float4 loads and stores
  bool g_vec;     // the gradient too, and contiguous
  bool in_place;  // the outputs are the inputs
};

struct Args {
  Leaf leaf[MAX_LEAVES];
  const uint8_t* mask;
  const float *c1, *c2;
  float b1, omb1, b2, omb2, eps;
  int chunks;
};

__device__ __forceinline__ void load(const float* x, int e0, int cnt, bool vec, float (&out)[4]) {
  if (vec && cnt == 4) {
    const float4 q = *reinterpret_cast<const float4*>(x + e0);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
    for (int k = 0; k < cnt; ++k) out[k] = x[e0 + k];
  }
}

__device__ __forceinline__ void store(float* x, int e0, int cnt, bool vec, const float (&in)[4]) {
  if (vec && cnt == 4) {
    *reinterpret_cast<float4*>(x + e0) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    for (int k = 0; k < cnt; ++k) x[e0 + k] = in[k];
  }
}

// One chunk a thread: a grid sized to the chunks (~116,000 blocks at the
// post-opt cell) ran 10-15% faster on the H100 than a grid-stride loop over
// one or eight blocks an SM, which leaves SMs idle in the last wave.
__global__ void __launch_bounds__(THREADS) masked_adam_kernel(const __grid_constant__ Args a) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= a.chunks) return;
  int l = 0;
  while (c >= a.leaf[l].chunk_end) ++l;
  const Leaf& L = a.leaf[l];
  const int e0 = 4 * (c - (l ? a.leaf[l - 1].chunk_end : 0));
  const int cnt = min(4, L.n - e0);
  int row[4], col[4];
  bool on[4], any = false;
  int r = e0 / L.width, j = e0 - r * L.width;
  for (int k = 0; k < 4; ++k) {
    row[k] = r, col[k] = j;
    on[k] = k < cnt && a.mask[r];
    any |= on[k];
    if (++j == L.width) j = 0, ++r;
  }
  if (!any && L.in_place) return;
  float p[4], m[4], v[4];
  load(L.p, e0, cnt, L.vec, p);
  load(L.m, e0, cnt, L.vec, m);
  load(L.v, e0, cnt, L.vec, v);
  if (any) {
    float g[4];
    if (L.g_vec) {
      load(L.g, e0, cnt, true, g);
    } else {
      for (int k = 0; k < cnt; ++k) g[k] = L.g[(long long)row[k] * L.g_stride + col[k]];
    }
    const float lr = L.lr_dev ? *L.lr_dev : L.lr;
    for (int k = 0; k < cnt; ++k) {
      if (!on[k]) continue;
      m[k] = __fadd_rn(__fmul_rn(a.b1, m[k]), __fmul_rn(a.omb1, g[k]));
      v[k] = __fadd_rn(__fmul_rn(a.b2, v[k]), __fmul_rn(a.omb2, __fmul_rn(g[k], g[k])));
      const float m_hat = __fdiv_rn(m[k], a.c1[row[k]]);
      const float v_hat = __fdiv_rn(v[k], a.c2[row[k]]);
      p[k] = __fsub_rn(p[k], __fdiv_rn(__fmul_rn(lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), a.eps)));
    }
  }
  store(L.po, e0, cnt, L.vec, p);
  store(L.mo, e0, cnt, L.vec, m);
  store(L.vo, e0, cnt, L.vec, v);
}

bool aligned(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15) == 0; }

}  // namespace

// `ptrs`, `table` and `lrs` are host arrays of n_leaves entries (PTRS,
// TABLE and 1 per leaf, model/adam.py:launch_masked_adam); `mask` (rows,)
// bool, `c1` and `c2` (rows,) float32 on the device.
extern "C" int hidegs_masked_adam(const uint64_t* ptrs, const int* table, const float* lrs, const uint8_t* mask,
                                  const float* c1, const float* c2, int n_leaves, float b1, float omb1, float b2,
                                  float omb2, float eps, cudaStream_t stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Args a{};
  for (int l = 0; l < n_leaves; ++l) {
    const uint64_t* q = ptrs + PTRS * l;
    Leaf& L = a.leaf[l];
    L.p = reinterpret_cast<const float*>(q[0]);
    L.g = reinterpret_cast<const float*>(q[1]);
    L.m = reinterpret_cast<const float*>(q[2]);
    L.v = reinterpret_cast<const float*>(q[3]);
    L.po = reinterpret_cast<float*>(q[4]);
    L.mo = reinterpret_cast<float*>(q[5]);
    L.vo = reinterpret_cast<float*>(q[6]);
    L.lr_dev = reinterpret_cast<const float*>(q[7]);
    L.lr = lrs[l];
    L.width = table[TABLE * l];
    L.n = table[TABLE * l + 1];
    L.chunk_end = table[TABLE * l + 2];
    L.g_stride = table[TABLE * l + 3];
    if (L.width < 1 || L.n < 0 || L.g_stride < 0 || L.chunk_end < (l ? a.leaf[l - 1].chunk_end : 0))
      return (int)cudaErrorInvalidValue;
    L.vec = aligned(L.p) && aligned(L.m) && aligned(L.v) && aligned(L.po) && aligned(L.mo) && aligned(L.vo);
    L.g_vec = L.vec && aligned(L.g) && L.g_stride == L.width;
    L.in_place = L.po == L.p && L.mo == L.m && L.vo == L.v;
  }
  a.mask = mask;
  a.c1 = c1;
  a.c2 = c2;
  a.b1 = b1, a.omb1 = omb1, a.b2 = b2, a.omb2 = omb2, a.eps = eps;
  a.chunks = a.leaf[n_leaves - 1].chunk_end;
  if (a.chunks == 0) return 0;
  masked_adam_kernel<<<(a.chunks + THREADS - 1) / THREADS, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
