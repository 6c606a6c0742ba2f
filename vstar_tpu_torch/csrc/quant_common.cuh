// Pieces shared by the CUDA-core quantized-weight matvecs (K6 in
// int4_matmul.cu, P2-P4 in int4_variants.cu).
//
// Decode-shaped products (R <= 16 activation rows) are weight-streaming
// matvecs bound by the bytes of the weight: a block of kMvThreads threads
// owns a strip of kMvCols output columns and one split of the reduction
// dimension; each thread holds CPT neighbouring columns of that strip and
// walks the rows of its split with a stride of TR = kMvThreads / (kMvCols
// / CPT) "row lanes". The lanes' partial sums are added in lane order in
// shared memory (deterministic), each split writes its [R, strip] partial
// to an f32 workspace [splits, R, OUT], and `splitk_finish` adds the splits
// in order, applies an optional per-column scale and writes the output.
// The host chooses the split count so that the grid fills every SM to
// the kernel's occupancy (these kernels are bound by the loads each SM
// keeps in flight, so idle block slots cost bandwidth). K3 and K5 moved to
// the tensor-core decode rows of decode_rows.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vstar {

using bf16 = __nv_bfloat16;

constexpr int kMvThreads = 256;
constexpr int kMvCols = 256;
constexpr int kMaxRows = 16;

// Loads CPT consecutive bytes of one weight row starting at column c0
// into CPT / 4 little-endian words (byte j of the run is bits 8*(j%4) of
// w[j/4]); `left` = OUT - c0 columns are still inside the row. VEC: one
// aligned vector load (OUT and the base pointer are 16-byte aligned);
// otherwise (rows of a ragged OUT start at any byte) byte loads, with the
// ragged tail read as 0. Aligned-word loads funnel-shifted into place
// measured slower than byte loads on the 32003-wide lm_head (H100).
template <int CPT, bool VEC>
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ p,
                                           long long left,
                                           uint32_t (&w)[CPT / 4]) {
  static_assert(CPT == 4 || CPT == 8 || CPT == 16, "CPT is 4, 8 or 16");
  if constexpr (VEC) {
    if constexpr (CPT == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (CPT == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPT / 4; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * i + j < left) v |= (uint32_t)__ldg(p + 4 * i + j) << (8 * j);
      w[i] = v;
    }
  }
}

// Byte j of a run loaded by load_words, as a signed int8.
template <int N>
__device__ __forceinline__ int byte_s8(const uint32_t (&w)[N], int j) {
  return (int)(int8_t)(w[j >> 2] >> (8 * (j & 3)));
}

// Adds the per-thread partials acc[RB][CPT] of all row lanes into
// red[RB][CPT][TC] (column tc * CPT + j at [r][j][tc], so the writing
// lane's threads hit consecutive banks) in lane order, then stores rows <
// `rows` and columns < `out` of the block's strip into split `split` of
// the workspace.
template <int RB, int CPT>
__device__ __forceinline__ void reduce_and_store(const float (&acc)[RB][CPT],
                                                 float* __restrict__ red,
                                                 float* __restrict__ ws,
                                                 int rows, long long out,
                                                 int split) {
  constexpr int TC = kMvCols / CPT;
  constexpr int TR = kMvThreads / TC;
  const int tc = threadIdx.x % TC, lane = threadIdx.x / TC;
  for (int l = 0; l < TR; ++l) {
    if (lane == l) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float* dst = red + (r * CPT + j) * TC + tc;
          *dst = (l == 0 ? 0.f : *dst) + acc[r][j];
        }
    }
    __syncthreads();
  }
  const long long strip = (long long)blockIdx.x * kMvCols;
  for (int i = threadIdx.x; i < RB * kMvCols; i += kMvThreads) {
    const int r = i / kMvCols, col = i % kMvCols;
    const long long c = strip + col;
    if (r < rows && c < out)
      ws[((long long)split * rows + r) * out + c] = red[(r * CPT + col % CPT) * TC + col / CPT];
  }
}

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
