// K3 + K4: weight-only int8 matvec for decode-shaped rows on sm_90a.
//
// Replaces two Pallas kernels of the JAX package that compute the same
// function, y[R, OUT] = x[R, IN] @ (q int8 [IN, OUT] * s f32 [1, OUT]) for
// R <= 16: vstar_tpu/kernels/int8_matmul.py:_kernel (K3, a grid over output
// blocks with x resident) and vstar_tpu/kernels/stream_matvec.py:_kernel
// (K4, the same product with the weight streamed through a two-slot VMEM
// buffer by hand-issued DMAs, which existed only to hide the TPU's copy
// latency).
//
// What bounds it on the H100: the weight bytes. At R <= 16 the product
// does 2*R operations per weight byte, far below the ~590 int8-equivalent
// operations per byte where the tensor cores would become the limit;
// 4096 x 11008 int8 is 45.1 MB, 13.5 us at 3.35 TB/s. The design streams
// every weight byte exactly once with 16-byte loads along OUT (coalesced
// across a warp), keeps the block's slice of x in shared memory as f32,
// accumulates in f32 registers, and splits the reduction dimension across
// blocks (quant_common.cuh) so that even OUT = 4096 at R = 1 puts ~2 blocks
// on each of the 132 SMs. The per-column scale is applied once, in the
// split-K finish. Ragged OUT (the 32003-wide lm_head) takes byte loads.
#include "quant_common.cuh"

namespace {

using vstar::bf16;
using vstar::kMvCols;
using vstar::kMvThreads;

template <int RB, int CPT, bool VEC>
__global__ void __launch_bounds__(kMvThreads)
    int8_matvec_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                       float* __restrict__ ws, int rows, long long in,
                       long long out, long long kchunk) {
  constexpr int TC = kMvCols / CPT;
  constexpr int TR = kMvThreads / TC;
  extern __shared__ float smem[];
  float* xs = smem;                  // [RB][kchunk] f32 slice of x
  float* red = smem + RB * kchunk;   // [RB][kMvCols] lane reduction
  const long long k0 = (long long)blockIdx.y * kchunk;
  const int nk = (int)min(kchunk, in - k0);
  for (long long i = threadIdx.x; i < RB * kchunk; i += kMvThreads) {
    const int r = (int)(i / kchunk), k = (int)(i % kchunk);
    xs[i] = (r < rows && k < nk) ? __bfloat162float(x[r * in + k0 + k]) : 0.f;
  }
  __syncthreads();

  const int tc = threadIdx.x % TC, lane = threadIdx.x / TC;
  const long long c0 = (long long)blockIdx.x * kMvCols + tc * CPT;
  float acc[RB][CPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  if (c0 < out) {
    const uint8_t* wp = reinterpret_cast<const uint8_t*>(q) + (k0 + lane) * out + c0;
#pragma unroll 4
    for (int k = lane; k < nk; k += TR, wp += TR * out) {
      uint32_t w[CPT / 4];
      vstar::load_words<CPT, VEC>(wp, out - c0, w);
      float wf[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wf[j] = (float)vstar::byte_s8(w, j);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float xv = xs[r * kchunk + k];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
      }
    }
  }
  vstar::reduce_and_store<RB, CPT>(acc, red, ws, rows, out, blockIdx.y);
}

template <int RB, int CPT>
int launch(const bf16* x, const int8_t* q, const float* s, float* ws,
           void* y, int rows, long long in, long long out, long long kchunk,
           int splits, bool vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * RB * (kchunk + kMvCols);
  dim3 grid((unsigned)((out + kMvCols - 1) / kMvCols), (unsigned)splits);
  if (vec)
    int8_matvec_kernel<RB, CPT, true><<<grid, kMvThreads, smem, stream>>>(
        x, q, ws, rows, in, out, kchunk);
  else
    int8_matvec_kernel<RB, CPT, false><<<grid, kMvThreads, smem, stream>>>(
        x, q, ws, rows, in, out, kchunk);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_finish(ws, splits, rows, out, s, y, 1, stream);
}

template <int RB, int CPT>
int occupancy(bool vec, size_t smem, int* blocks) {
  return (int)(vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, int8_matvec_kernel<RB, CPT, true>, kMvThreads, smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, int8_matvec_kernel<RB, CPT, false>, kMvThreads, smem));
}

}  // namespace

// Blocks of the launch for `rows` (<= 16) and `vec` that one SM holds at
// `smem` bytes of dynamic shared memory, into *blocks.
extern "C" int vstar_int8_matvec_occupancy(long long rows, long long vec,
                                           long long smem, void* blocks) {
  auto* b = static_cast<int*>(blocks);
  switch (row_bucket(rows)) {
    case 1: return occupancy<1, 16>(vec, smem, b);
    case 2: return occupancy<2, 16>(vec, smem, b);
    case 4: return occupancy<4, 16>(vec, smem, b);
    case 8: return occupancy<8, 8>(vec, smem, b);
    default: return occupancy<16, 4>(vec, smem, b);
  }
}

// y [rows, out] bf16 = x [rows, in] bf16 @ (q [in, out] int8 * s [out] f32),
// rows <= 16, all contiguous. ws: f32 [splits, rows, out]; split i covers
// rows [i * kchunk, (i + 1) * kchunk) of q, and RB * kchunk f32 of x must
// fit 48 KB of shared memory with the reduction buffer. vec: out % 16 == 0
// and q is 16-byte aligned.
extern "C" int vstar_int8_matvec(const void* x, const void* q, const void* s,
                                 void* ws, void* y, long long rows,
                                 long long in, long long out,
                                 long long kchunk, long long splits,
                                 long long vec, void* stream) {
  if (rows < 1 || rows > vstar::kMaxRows || kchunk < 1 || splits < 1 ||
      (splits - 1) * kchunk >= in || splits * kchunk < in)
    return (int)cudaErrorInvalidValue;
  const int rb = row_bucket(rows);
  if (sizeof(float) * rb * (kchunk + kMvCols) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const bf16*>(x);
  auto* qb = static_cast<const int8_t*>(q);
  auto* sf = static_cast<const float*>(s);
  auto* wf = static_cast<float*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  const int r = (int)rows, sp = (int)splits;
  switch (rb) {
    case 1: return launch<1, 16>(xb, qb, sf, wf, y, r, in, out, kchunk, sp, vec, st);
    case 2: return launch<2, 16>(xb, qb, sf, wf, y, r, in, out, kchunk, sp, vec, st);
    case 4: return launch<4, 16>(xb, qb, sf, wf, y, r, in, out, kchunk, sp, vec, st);
    case 8: return launch<8, 8>(xb, qb, sf, wf, y, r, in, out, kchunk, sp, vec, st);
    default: return launch<16, 4>(xb, qb, sf, wf, y, r, in, out, kchunk, sp, vec, st);
  }
}
