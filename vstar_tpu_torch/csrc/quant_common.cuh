// Pieces of the CUDA-core W4A8 kernels of the int4 profile (P2, P3 in
// int4_variants.cu): decode-shaped products (R <= 16 activation rows)
// whose splits of the reduction dimension write an f32 workspace [splits,
// R, OUT], which `splitk_finish` adds in order (deterministic) into the
// output. K3, K5, K6 and P4 moved to the tensor-core decode rows of
// decode_rows.cuh (one launch, no workspace).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vstar {

using bf16 = __nv_bfloat16;

constexpr int kMaxRows = 16;

}  // namespace vstar

namespace {

// out[r, c] = (sum over splits of ws[s, r, c]) * (col_scale ? col_scale[c] : 1),
// written as bf16 (out_bf16) or f32, contiguous [rows, out].
__global__ void splitk_finish(const float* __restrict__ ws, int splits,
                              long long rows, long long out,
                              const float* __restrict__ col_scale,
                              void* __restrict__ dst, int out_bf16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * out) return;
  const long long c = i % out;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += ws[(long long)s * rows * out + i];
  if (col_scale) acc *= col_scale[c];
  if (out_bf16)
    static_cast<vstar::bf16*>(dst)[i] = __float2bfloat16(acc);
  else
    static_cast<float*>(dst)[i] = acc;
}

inline int launch_finish(const float* ws, int splits, long long rows,
                         long long out, const float* col_scale, void* dst,
                         int out_bf16, cudaStream_t stream) {
  const long long n = rows * out;
  splitk_finish<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      ws, splits, rows, out, col_scale, dst, out_bf16);
  return (int)cudaGetLastError();
}

// The row-count bucket a launch is instantiated for (1, 2, 4, 8 or 16).
inline int row_bucket(long long rows) {
  int rb = 1;
  while (rb < rows) rb *= 2;
  return rb;
}

}  // namespace
