// The scalar gradient fold, the design hidegs_tpu_torch/raster/csrc/
// blend_bwd.cu:fold_rows_kernel replaced: one thread per (gaussian, column),
// each reading its span bounds itself and walking the span one float at a
// time, fed by a separate scatter of the sorted-instance rows into expansion
// order (blend_plain.expansion_rows). Kept outside the package as the
// yardstick that chip_smoke.py and tests/test_torch_cuda.py hold the
// package's fold against (bitwise, and timed in turns). Nothing in
// hidegs_tpu_torch calls it.
//
// Build: nvcc with cuda_blend.NVCC_FLAGS (cuda_blend.build does it).

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 16;

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

// hidegs_fold_rows_scalar — rows_exp: (I, 16) float32 rows in expansion order;
// g_start: (N + 1,) int32, clamped to I; out: (N, 16) float32. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int hidegs_fold_rows_scalar(const void* rows_exp, const void* g_start,
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
