// K5 (W4A16) and K6 (W4A8): group-wise int4 weight matmuls on sm_90a.
//
// Replaces vstar_tpu/kernels/int4_matmul.py:_kernel (K5) and
// :_w4a8_kernel (K6). Weight format (nn/quant.quantize_weight_int4):
// q4 uint8 [IN/2, OUT], packed row p holds input 2p in its low nibble and
// 2p+1 in its high nibble, both two's-complement signed 4-bit; s4 f32
// [IN/group, OUT], one scale per (group of `group` inputs, column).
//
// K5  y[R, OUT] (bf16) = x[R, IN] (bf16) @ (nib * s4)
//   R <= 16 (decode, verify, lm_head rows): a weight-streaming matvec
//   bound by the packed bytes (4096 x 11008 is 22.5 MB of nibbles plus
//   1.4 MB of scales, ~7.1 us at 3.35 TB/s). Threads read 4-16 bytes of a
//   packed row along OUT, unpack both signed nibbles in registers,
//   accumulate x * nib for one group in f32 and apply the group's f32 scale
//   once per group; the reduction dimension is split across blocks to fill
//   the 132 SMs (quant_common.cuh).
//   R > 16 (prefill at 384-768 rows, option chunks): compute-bound tiles.
//   A block of 8 warps owns a 64 x 128 output tile; per 64-deep step it
//   stages x as bf16 and the dequantized weights (16 packed bytes per
//   thread, nib * scale rounded to bf16 as the TPU kernel does) in shared
//   memory and runs bf16 WMMA 16x16x16 with f32 accumulation. Weights are
//   re-read once per 64-row tile (from L2 at these sizes).
// K6  y[R, OUT] (f32) = xq[R, IN] (int8) @ nib, with each group's exact
//   int32 dot scaled by s4 / 16 (the activation scale is the caller's), for
//   R <= 16. The packed bytes are turned into 16 * nib without unpacking
//   (high nibble: b & 0xF0; low nibble: (b << 4) & 0xF0, as int8), four
//   consecutive inputs of one column are gathered into one word with
//   __byte_perm, and __dp4a does four exact int8 products per instruction.
//   Same streaming and split layout as K5's decode path.
//
// Both take any OUT, including the ragged 32003-wide lm_head: columns past
// OUT are masked (byte loads where OUT is not a multiple of 16).
#include <mma.h>

#include "quant_common.cuh"

namespace {

using vstar::bf16;
using vstar::kMvCols;
using vstar::kMvThreads;
namespace wmma = nvcuda::wmma;

// ---------------------------------------------------------------------------
// K5, R <= 16: streaming matvec
// ---------------------------------------------------------------------------

// Block (strip, split): groups [split * gchunk, ...) of the reduction.
template <int RB, int CPT, bool VEC>
__global__ void __launch_bounds__(kMvThreads)
    int4_matvec_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q4,
                       const float* __restrict__ s4, float* __restrict__ ws,
                       int rows, long long in, long long out, int group,
                       long long gchunk, long long ng) {
  constexpr int TC = kMvCols / CPT;
  constexpr int TR = kMvThreads / TC;
  extern __shared__ float smem[];
  const long long kchunk = gchunk * group;
  float* xs = smem;                  // [RB][kchunk] f32 slice of x
  float* red = smem + RB * kchunk;   // [RB][kMvCols]
  const long long g0 = (long long)blockIdx.y * gchunk;
  const long long g1 = min(ng, g0 + gchunk);
  const long long k0 = g0 * group;
  const int nk = (int)((g1 - g0) * group);
  for (long long i = threadIdx.x; i < RB * kchunk; i += kMvThreads) {
    const int r = (int)(i / kchunk), k = (int)(i % kchunk);
    xs[i] = (r < rows && k < nk) ? __bfloat162float(x[r * in + k0 + k]) : 0.f;
  }
  __syncthreads();

  const int tc = threadIdx.x % TC, lane = threadIdx.x / TC;
  const long long c0 = (long long)blockIdx.x * kMvCols + tc * CPT;
  const int half = group / 2;        // packed rows per group
  float acc[RB][CPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  if (c0 < out) {
    for (long long g = g0; g < g1; ++g) {
      float part[RB][CPT];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) part[r][j] = 0.f;
      const uint8_t* wp = q4 + (g * half + lane) * out + c0;
#pragma unroll 2
      for (int pp = lane; pp < half; pp += TR, wp += TR * out) {
        uint32_t w[CPT / 4];
        vstar::load_words<CPT, VEC>(wp, out - c0, w);
        float lo[CPT], hi[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int b = vstar::byte_s8(w, j);    // sign-extended byte
          lo[j] = (float)((int)(int8_t)(b << 4) >> 4);
          hi[j] = (float)(b >> 4);
        }
        const int k = (int)((g - g0) * group) + 2 * pp;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xe = xs[r * kchunk + k], xo = xs[r * kchunk + k + 1];
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            part[r][j] = fmaf(xo, hi[j], fmaf(xe, lo[j], part[r][j]));
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float s = c0 + j < out ? __ldg(s4 + g * out + c0 + j) : 0.f;
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r][j] = fmaf(part[r][j], s, acc[r][j]);
      }
    }
  }
  vstar::reduce_and_store<RB, CPT>(acc, red, ws, rows, out, blockIdx.y);
}

// ---------------------------------------------------------------------------
// K6, R <= 16: W4A8 streaming matvec with exact int32 group dots
// ---------------------------------------------------------------------------

// xq is staged as words: word kw of row r holds inputs 4kw .. 4kw+3.
template <int RB, bool VEC>
__global__ void __launch_bounds__(kMvThreads)
    int4_w4a8_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ q4,
                     const float* __restrict__ s4, float* __restrict__ ws,
                     int rows, long long in, long long out, int group,
                     long long gchunk, long long ng) {
  constexpr int CPT = 4;
  constexpr int TC = kMvCols / CPT;
  constexpr int TR = kMvThreads / TC;
  extern __shared__ float smem[];
  const long long wchunk = gchunk * group / 4;        // x words per row
  int* xw = reinterpret_cast<int*>(smem);             // [RB][wchunk]
  float* red = smem + RB * wchunk;                    // [RB][kMvCols]
  const long long g0 = (long long)blockIdx.y * gchunk;
  const long long g1 = min(ng, g0 + gchunk);
  const long long w0 = g0 * group / 4;
  const long long nw = (g1 - g0) * group / 4;
  const int* xrow = reinterpret_cast<const int*>(xq);
  for (long long i = threadIdx.x; i < RB * wchunk; i += kMvThreads) {
    const int r = (int)(i / wchunk);
    const long long kw = i % wchunk;
    xw[i] = (r < rows && kw < nw) ? xrow[r * (in / 4) + w0 + kw] : 0;
  }
  __syncthreads();

  const int tc = threadIdx.x % TC, lane = threadIdx.x / TC;
  const long long c0 = (long long)blockIdx.x * kMvCols + tc * CPT;
  const int pairs = group / 4;       // packed-row pairs per group
  float acc[RB][CPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  if (c0 < out) {
    for (long long g = g0; g < g1; ++g) {
      int dot[RB][CPT];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) dot[r][j] = 0;
      // pair pp covers packed rows 2pp, 2pp+1 of the group = inputs 4pp..4pp+3
      const uint8_t* wp = q4 + (g * (group / 2) + 2 * lane) * out + c0;
#pragma unroll 2
      for (int pp = lane; pp < pairs; pp += TR, wp += 2 * TR * out) {
        uint32_t a[1], b[1];
        vstar::load_words<CPT, VEC>(wp, out - c0, a);
        vstar::load_words<CPT, VEC>(wp + out, out - c0, b);
        const uint32_t l0 = (a[0] << 4) & 0xF0F0F0F0u, h0 = a[0] & 0xF0F0F0F0u;
        const uint32_t l1 = (b[0] << 4) & 0xF0F0F0F0u, h1 = b[0] & 0xF0F0F0F0u;
        const uint32_t t0 = __byte_perm(l0, h0, 0x5140), t1 = __byte_perm(l0, h0, 0x7362);
        const uint32_t u0 = __byte_perm(l1, h1, 0x5140), u1 = __byte_perm(l1, h1, 0x7362);
        // column j: [16*lo(row 2pp), 16*hi(row 2pp), 16*lo(row 2pp+1), 16*hi(row 2pp+1)]
        const int col[CPT] = {(int)__byte_perm(t0, u0, 0x5410), (int)__byte_perm(t0, u0, 0x7632),
                              (int)__byte_perm(t1, u1, 0x5410), (int)__byte_perm(t1, u1, 0x7632)};
        const long long kw = (g - g0) * pairs + pp;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int xv = xw[r * wchunk + kw];
#pragma unroll
          for (int j = 0; j < CPT; ++j) dot[r][j] = __dp4a(xv, col[j], dot[r][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float s = c0 + j < out ? __ldg(s4 + g * out + c0 + j) * (1.f / 16.f) : 0.f;
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r][j] = fmaf((float)dot[r][j], s, acc[r][j]);
      }
    }
  }
  vstar::reduce_and_store<RB, CPT>(acc, red, ws, rows, out, blockIdx.y);
}

// ---------------------------------------------------------------------------
// K5, R > 16: bf16 tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kTm = 64, kTn = 128, kTk = 64;  // output tile and depth step
constexpr int kTcThreads = 256;               // 8 warps, 2 x 4 of 32x32
constexpr int kLda = kTk + 8;                 // bf16 row stride of the x tile
constexpr int kLdb = kTn + 8;                 // bf16 row stride of the w tile
constexpr int kLdf = kTn + 4;                 // f32 row stride of the out tile

// Shared memory: the bf16 x tile [64 rows][64 k] and weight tile
// [64 k][128 cols] during the k loop, then (reused) the f32 output tile.
constexpr int kTcInBytes = (kTm * kLda + kTk * kLdb) * (int)sizeof(bf16);
constexpr int kTcOutBytes = kTm * kLdf * (int)sizeof(float);
constexpr int kTcSmemBytes = kTcInBytes > kTcOutBytes ? kTcInBytes : kTcOutBytes;

template <bool VEC>
__global__ void __launch_bounds__(kTcThreads)
    int4_matmul_tc_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q4,
                          const float* __restrict__ s4, bf16* __restrict__ y,
                          long long rows, long long in, long long out, int group) {
  __shared__ __align__(128) unsigned char smem[kTcSmemBytes];
  bf16* xa = reinterpret_cast<bf16*>(smem);
  bf16* wb = xa + kTm * kLda;
  float* o = reinterpret_cast<float*>(smem);
  const long long r0 = (long long)blockIdx.y * kTm, n0 = (long long)blockIdx.x * kTn;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 4) * 32, wc = (warp % 4) * 32;   // warp's 32x32 sub-tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // weight tile: thread -> (packed row pr, 16 columns from cs)
  const int pr = threadIdx.x / (kTn / 16), cs = (threadIdx.x % (kTn / 16)) * 16;
  const long long n = n0 + cs;
  for (long long k0 = 0; k0 < in; k0 += kTk) {
    // x tile: 64 rows x 64 k, 8 bf16 (16 bytes) per load; in % 8 == 0
    for (int i = threadIdx.x; i < kTm * (kTk / 8); i += kTcThreads) {
      const int r = i / (kTk / 8), c = (i % (kTk / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows && k0 + c < in)
        v = *reinterpret_cast<const uint4*>(x + (r0 + r) * in + k0 + c);
      *reinterpret_cast<uint4*>(xa + r * kLda + c) = v;
    }
    {
      const long long p = k0 / 2 + pr;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      float sc[16];
      if (2 * p < in && n < out) {
        vstar::load_words<16, VEC>(q4 + p * out + n, out - n, w);
        const float* srow = s4 + ((2 * p) / group) * out + n;
#pragma unroll
        for (int j = 0; j < 16; ++j) sc[j] = n + j < out ? __ldg(srow + j) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) sc[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int b = vstar::byte_s8(w, j);
        wb[(2 * pr) * kLdb + cs + j] =
            __float2bfloat16((float)((int)(int8_t)(b << 4) >> 4) * sc[j]);
        wb[(2 * pr + 1) * kLdb + cs + j] = __float2bfloat16((float)(b >> 4) * sc[j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xa + (wr + 16 * i) * kLda + kk, kLda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], wb + kk * kLdb + wc + 16 * j, kLdb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(o + (wr + 16 * i) * kLdf + wc + 16 * j, acc[i][j], kLdf,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kTm * kTn; i += kTcThreads) {
    const int r = i / kTn, c = i % kTn;
    if (r0 + r < rows && n0 + c < out)
      y[(r0 + r) * out + n0 + c] = __float2bfloat16(o[r * kLdf + c]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int RB, int CPT>
int launch_k5_stream(const bf16* x, const uint8_t* q4, const float* s4, float* ws,
                     void* y, int rows, long long in, long long out, int group,
                     long long gchunk, int splits, bool vec, cudaStream_t st) {
  const size_t smem = sizeof(float) * RB * (gchunk * group + kMvCols);
  const long long ng = in / group;
  dim3 grid((unsigned)((out + kMvCols - 1) / kMvCols), (unsigned)splits);
  if (vec)
    int4_matvec_kernel<RB, CPT, true><<<grid, kMvThreads, smem, st>>>(
        x, q4, s4, ws, rows, in, out, group, gchunk, ng);
  else
    int4_matvec_kernel<RB, CPT, false><<<grid, kMvThreads, smem, st>>>(
        x, q4, s4, ws, rows, in, out, group, gchunk, ng);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_finish(ws, splits, rows, out, nullptr, y, 1, st);
}

template <int RB>
int launch_k6(const int8_t* xq, const uint8_t* q4, const float* s4, float* ws,
              void* y, int rows, long long in, long long out, int group,
              long long gchunk, int splits, bool vec, cudaStream_t st) {
  const size_t smem = sizeof(float) * RB * (gchunk * group / 4 + kMvCols);
  const long long ng = in / group;
  dim3 grid((unsigned)((out + kMvCols - 1) / kMvCols), (unsigned)splits);
  if (vec)
    int4_w4a8_kernel<RB, true><<<grid, kMvThreads, smem, st>>>(
        xq, q4, s4, ws, rows, in, out, group, gchunk, ng);
  else
    int4_w4a8_kernel<RB, false><<<grid, kMvThreads, smem, st>>>(
        xq, q4, s4, ws, rows, in, out, group, gchunk, ng);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_finish(ws, splits, rows, out, nullptr, y, 0, st);
}

template <int RB, int CPT>
int occupancy_k5(bool vec, size_t smem, int* blocks) {
  return (int)(vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, int4_matvec_kernel<RB, CPT, true>, kMvThreads, smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, int4_matvec_kernel<RB, CPT, false>, kMvThreads, smem));
}

template <int RB>
int occupancy_k6(bool vec, size_t smem, int* blocks) {
  return (int)(vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, int4_w4a8_kernel<RB, true>, kMvThreads, smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, int4_w4a8_kernel<RB, false>, kMvThreads, smem));
}

// Shared checks of the split plan: splits * gchunk groups cover the ng
// groups with no empty split, and the staged x slice fits 48 KB with the
// reduction buffer.
bool bad_plan(long long rows, long long ng, long long gchunk, long long splits,
              size_t smem) {
  return rows < 1 || rows > vstar::kMaxRows || gchunk < 1 || splits < 1 ||
         (splits - 1) * gchunk >= ng || splits * gchunk < ng || smem > 48 * 1024;
}

}  // namespace

// Blocks of K6's (w4a8 != 0) or K5's decode-row launch for `rows` (<= 16)
// and `vec` that one SM holds at `smem` bytes of dynamic shared memory,
// into *blocks.
extern "C" int vstar_int4_occupancy(long long w4a8, long long rows, long long vec,
                                    long long smem, void* blocks) {
  auto* b = static_cast<int*>(blocks);
  const int rb = row_bucket(rows);
  if (w4a8) {
    switch (rb) {
      case 1: return occupancy_k6<1>(vec, smem, b);
      case 2: return occupancy_k6<2>(vec, smem, b);
      case 4: return occupancy_k6<4>(vec, smem, b);
      case 8: return occupancy_k6<8>(vec, smem, b);
      default: return occupancy_k6<16>(vec, smem, b);
    }
  }
  switch (rb) {
    case 1: return occupancy_k5<1, 16>(vec, smem, b);
    case 2: return occupancy_k5<2, 16>(vec, smem, b);
    case 4: return occupancy_k5<4, 8>(vec, smem, b);
    case 8: return occupancy_k5<8, 4>(vec, smem, b);
    default: return occupancy_k5<16, 4>(vec, smem, b);
  }
}

// K5: y [rows, out] bf16 = x [rows, in] bf16 @ dequant(q4 [in/2, out],
// s4 [in/group, out]); contiguous operands, group even, in % 8 == 0.
// rows <= 16 takes the streaming matvec (ws f32 [splits, rows, out], split
// i covers groups [i * gchunk, (i + 1) * gchunk); vec: out % 16 == 0 and q4
// 16-byte aligned); rows > 16 the tensor-core tiles (ws, gchunk, splits
// and vec unused).
extern "C" int vstar_int4_matmul(const void* x, const void* q4, const void* s4,
                                 void* ws, void* y, long long rows, long long in,
                                 long long out, long long group, long long gchunk,
                                 long long splits, long long vec, void* stream) {
  if (group < 2 || group % 2 || in % group || in % 8 || rows < 1)
    return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const bf16*>(x);
  auto* qb = static_cast<const uint8_t*>(q4);
  auto* sf = static_cast<const float*>(s4);
  auto st = static_cast<cudaStream_t>(stream);
  if (rows > vstar::kMaxRows) {
    dim3 grid((unsigned)((out + kTn - 1) / kTn), (unsigned)((rows + kTm - 1) / kTm));
    auto* yb = static_cast<bf16*>(y);
    if (vec)
      int4_matmul_tc_kernel<true><<<grid, kTcThreads, 0, st>>>(xb, qb, sf, yb, rows, in,
                                                               out, (int)group);
    else
      int4_matmul_tc_kernel<false><<<grid, kTcThreads, 0, st>>>(xb, qb, sf, yb, rows, in,
                                                                out, (int)group);
    return (int)cudaGetLastError();
  }
  const int rb = row_bucket(rows);
  if (bad_plan(rows, in / group, gchunk, splits,
               sizeof(float) * rb * (gchunk * group + kMvCols)))
    return (int)cudaErrorInvalidValue;
  auto* wf = static_cast<float*>(ws);
  const int r = (int)rows, g = (int)group, sp = (int)splits;
  switch (rb) {
    case 1: return launch_k5_stream<1, 16>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    case 2: return launch_k5_stream<2, 16>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    case 4: return launch_k5_stream<4, 8>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    case 8: return launch_k5_stream<8, 4>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    default: return launch_k5_stream<16, 4>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
  }
}

// K6: y [rows, out] f32 = xq [rows, in] int8 @ nib(q4) with per-group
// int32 dots scaled by s4 / 16 (no activation scale); rows <= 16,
// group % 4 == 0, contiguous operands, xq 4-byte aligned. ws, gchunk,
// splits and vec as for K5's streaming path.
extern "C" int vstar_int4_w4a8(const void* xq, const void* q4, const void* s4,
                               void* ws, void* y, long long rows, long long in,
                               long long out, long long group, long long gchunk,
                               long long splits, long long vec, void* stream) {
  if (group < 4 || group % 4 || in % group) return (int)cudaErrorInvalidValue;
  const int rb = row_bucket(rows);
  if (bad_plan(rows, in / group, gchunk, splits,
               sizeof(float) * rb * (gchunk * group / 4 + kMvCols)))
    return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const int8_t*>(xq);
  auto* qb = static_cast<const uint8_t*>(q4);
  auto* sf = static_cast<const float*>(s4);
  auto* wf = static_cast<float*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  const int r = (int)rows, g = (int)group, sp = (int)splits;
  switch (rb) {
    case 1: return launch_k6<1>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    case 2: return launch_k6<2>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    case 4: return launch_k6<4>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    case 8: return launch_k6<8>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
    default: return launch_k6<16>(xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, vec, st);
  }
}
