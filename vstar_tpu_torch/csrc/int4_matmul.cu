// K5 (W4A16) and K6 (W4A8): group-wise int4 weight matmuls on sm_90a.
//
// Replaces vstar_tpu/kernels/int4_matmul.py:_kernel (K5) and
// :_w4a8_kernel (K6). Weight format (nn/quant.quantize_weight_int4):
// q4 uint8 [IN/2, OUT], packed row p holds input 2p in its low nibble and
// 2p+1 in its high nibble, both two's-complement signed 4-bit; s4 f32
// [IN/group, OUT], one scale per (group of `group` inputs, column).
//
// K5  y[R, OUT] (bf16) = x[R, IN] (bf16) @ (nib * s4)
//   R <= 16 (decode, verify, lm_head rows): bound by the packed bytes
//   (4096 x 11008 is 22.5 MB of nibbles plus 0.2 MB of scales, ~7.1 us at
//   3.35 TB/s). Tensor-core decode rows (below): nibbles unpacked by bit
//   operations straight into bf16 mma operands, a cp.async ring per warp,
//   split-K added in order across a thread-block cluster; one launch.
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
//   Streamed and split as the int8 matvec (quant_common.cuh).
//
// Both take any OUT, including the ragged 32003-wide lm_head: columns past
// OUT are masked.
#include <cooperative_groups.h>
#include <mma.h>

#include "attention_common.cuh"
#include "quant_common.cuh"

namespace {

using vstar::bf16;
using vstar::kMvCols;
using vstar::kMvThreads;
namespace wmma = nvcuda::wmma;
namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// K5, R <= 16: decode rows on tensor cores
// ---------------------------------------------------------------------------
//
// y^T [OUT, R] = W^T x^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate):
// the output columns are the M rows, the activation rows the N columns
// (8 per n-tile, two at 16 rows), the inputs the K depth. The product does
// not depend on the order of the output columns or of the inputs within a
// group, so both are permuted to fit the bytes as they lie:
//   A  thread (g, t4) of a warp reads, per k-step of 16 inputs, 16
//      neighbouring columns (16g .. 16g + 15 of the warp's 128) of packed
//      rows t4 and 4 + t4. __byte_perm pairs the two rows' bytes of a
//      column, so that one 32-bit register holds the low (or high) nibbles
//      of both rows: the inputs 2p, 2p' (or 2p + 1, 2p' + 1) of that
//      column, which mma takes as the k-pair (2t4, 2t4 + 1) (or (8 + 2t4,
//      9 + 2t4)). M row g of m-tile T is column 16g + 2T, M row g + 8 is
//      column 16g + 2T + 1.
//   unpack  no integer-to-float conversion: lop3 masks two nibbles into
//      the mantissas of bf16x2 128 + (n ^ 8) (one instruction, the XOR
//      included), and one fma.rn.bf16x2 subtracts 136, exactly.
//   B  x in the same input order: the pair words (2t4, 2t4 + 1) and (8 +
//      2t4, 9 + 2t4) of row g, re-paired by __byte_perm.
// Per group the f32 mma sums are the group dot; it is scaled by s4 in f32
// and added to the accumulator, as int4_matmul_kernel_math does for at
// most 16 rows.
//
// Streaming: a block of 4 warps owns a strip of 128 columns; each warp a
// split of whole groups, streamed through a warp-private 3-stage cp.async
// ring (32 packed rows, their 64 inputs of x, and at a group's end its
// 128 scales per stage), so each SM keeps its blocks' stages in flight.
// That shape (VSTAR_K5_DECODE) won a sweep of stage rows, stages, warps
// side by side along the columns and k-splits per block, cluster sizes
// and L2 prefetch hints (vstar_tpu_torch/scripts/kernel_probe.py
// --k5-shapes; PERF.md); the template keeps those knobs for the sweep.
// The blocks of one strip form a thread-block cluster (1, 2, 4 or 8
// blocks, from the host's plan). After the stream each warp leaves its partial [R,
// 128] f32 in its own ring; after a cluster barrier every block adds, for
// its share of the strip's outputs, the partials of all splits in split
// order (block rank, then warp) through distributed shared memory and
// writes y in bf16. No workspace, no second launch, no atomics.
//
// What bounds it (H100, measured at R = 1 on 4096x11008, 0.019 ms): about
// half is fixed cost: ~3.5 us for a launch of blocks that do nothing,
// ~4 us for the ring's x and scale copies and waits, ~2 us for the
// cluster reduction. The weight stream adds ~6 us (22.5 MB at about the
// 3.35 TB/s peak) and the products ~3 us beyond it.
//
// Ragged rows (OUT % 16, the 32003-wide lm_head, or unaligned operands):
// a row's 128 columns are copied as the nine aligned 16-byte chunks that
// cover them (chunks outside the tensor are zero-filled), and a thread
// funnel-shifts its 16 bytes out of five words by the row's byte offset.

constexpr int kDcCols = 128;                // columns of a warp
constexpr int kDcMaxCluster = 8;            // portable cluster size

// The shipped decode-row shape: packed rows of a ring stage, ring stages,
// warps side by side along the columns (WC) and k-splits (WK) per block.
#define VSTAR_K5_DECODE 32, 3, 1, 4, 0

// A k-split's ring, shared by its WC warps: STAGES stages of SROWS packed
// rows of the block's 128 * WC columns (the weights), their 2 * SROWS
// inputs of x for RB rows, and the scales of the group a stage ends.
// PF: the L2 prefetch size the weight copies ask for (0: none, 1: 128
// bytes, 2: 256 bytes); kernel_probe.py's timing breakdown adds 4 (no
// products), 8 (no weight copies), 16 (nothing at all) or 32 (no
// reduction of the splits), which give wrong results.
template <int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
struct DecodeSmem {
  static constexpr int cols = kDcCols * WC;                         // strip
  static constexpr int w_chunks = cols / 16 + (ALIGNED ? 0 : 1);   // per row
  static constexpr int w_row = w_chunks * 16;                       // bytes
  static constexpr size_t w_bytes = (size_t)SROWS * w_row;
  static constexpr int x_row = SROWS * 4;                           // bytes
  static constexpr int x_chunks = x_row / 16;
  static constexpr int x_swz = (x_chunks < 8 ? x_chunks : 8) - 1;
  static constexpr size_t x_bytes = (size_t)RB * x_row;
  static constexpr size_t s_bytes = (size_t)cols * 4;
  static constexpr size_t stage = w_bytes + x_bytes + s_bytes;
  static constexpr size_t ring = STAGES * stage;
  static constexpr size_t bytes = WK * ring;
  static_assert(SROWS % 8 == 0 && SROWS >= 16 && STAGES >= 3, "decode ring shape");
  static_assert((size_t)WC * RB * kDcCols * 4 <= ring, "the partials fit the ring");
};

// cp.async16 asking L2 to prefetch 128 (PF 1) or 256 (PF 2) bytes around
// the copy.
template <int PF>
__device__ __forceinline__ void cp_async16_pf(uint32_t dst, const void* src, bool pred) {
  if constexpr ((PF & 3) == 0)
    vstar::cp_async16(dst, src, pred);
  else if constexpr ((PF & 3) == 1)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(pred ? 16 : 0));
  else
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(pred ? 16 : 0));
}

// Two nibbles of v (bits 0-3 and 16-19, two's-complement) as bf16x2.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  uint32_t r;
  // (v & 0x000F000F) ^ 0x43084308: bf16 128 + (n ^ 8) in each half
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(r) : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  // * 1 - 136: n, exactly
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

template <int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
__global__ void __launch_bounds__(WC * WK * 32)
    int4_decode_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q4,
                       const float* __restrict__ s4, bf16* __restrict__ y, int rows,
                       long long in, long long out, int group, int per) {
  using L = DecodeSmem<RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  constexpr int NT = RB / 8, GT = WC * 32, NTHR = WC * WK * 32;
  if constexpr ((PF & 16) != 0) return;
  extern __shared__ __align__(128) unsigned char dc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp % WC, wk = warp / WC, gtid = wc * 32 + lane;
  const int g = lane >> 2, t4 = lane & 3;
  const long long c0 = (long long)(blockIdx.x / csize) * L::cols;   // the strip's
  const long long ng = in / group;
  const long long g0 = min(ng, (long long)(rank * WK + wk) * per);
  const long long g1 = min(ng, g0 + per);
  const int spg = group / (2 * SROWS);        // ring stages per group
  const int n_st = (int)(g1 - g0) * spg;
  const long long p_first = g0 * group / 2;   // the split's first packed row
  unsigned char* ring = dc_smem + wk * L::ring;
  const uint32_t ring_u = vstar::smem_u32(ring);
  const uint8_t* q4_end = q4 + in / 2 * out;
  // the k-split's WC warps move through the ring together
  auto split_sync = [&]() {
    if constexpr (WC == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" :: "r"(1 + wk), "r"(GT) : "memory");
  };

  auto load_stage = [&](int i, int slot) {
    const uint32_t dst = ring_u + slot * (uint32_t)L::stage;
    const long long p0 = p_first + (long long)i * SROWS;
    if constexpr ((PF & 8) != 0) {
    } else if constexpr (ALIGNED) {
      // rows of 128 * WC contiguous bytes; 16-byte chunk c of row r goes
      // to warp slice c / 8 at (c % 8) ^ 2 (r % 4), so that a
      // quarter-warp's reads (rows t4, chunks g) miss each other
#pragma unroll
      for (int it = 0; it < SROWS / 4; ++it) {
        const int idx = gtid + GT * it, r = idx / (L::cols / 16), c = idx % (L::cols / 16);
        const bool ok = c0 + 16 * c < out;
        const uint8_t* src = ok ? q4 + (p0 + r) * out + c0 + 16 * c : q4;
        cp_async16_pf<PF>(dst + r * L::w_row + (c >> 3) * kDcCols +
                              (((c & 7) ^ ((r & 3) << 1)) << 4), src, ok);
      }
    } else {
      // the aligned 16-byte chunks that cover each row's 128 * WC columns
      for (int idx = gtid; idx < SROWS * L::w_chunks; idx += GT) {
        const int r = idx / L::w_chunks, c = idx % L::w_chunks;
        const uintptr_t a =
            (reinterpret_cast<uintptr_t>(q4 + (p0 + r) * out + c0) & ~(uintptr_t)15) + 16 * c;
        const bool ok = a + 16 > reinterpret_cast<uintptr_t>(q4) &&
                        a < reinterpret_cast<uintptr_t>(q4_end);
        cp_async16_pf<PF>(dst + r * L::w_row + 16 * c,
                          ok ? reinterpret_cast<const void*>(a) : q4, ok);
      }
    }
    // x rows [0, rows), inputs [2 p0, 2 p0 + 2 SROWS): chunk c of row r
    // at c ^ (r % 8) (fewer chunks: r modulo their count)
    const uint32_t xd = dst + (uint32_t)L::w_bytes;
    for (int idx = gtid; idx < rows * L::x_chunks; idx += GT) {
      const int r = idx / L::x_chunks, c = idx % L::x_chunks;
      // through L1 (.ca): every k-split of every strip on the SM reads the
      // same x, which through L2 alone makes one hot line per stage
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                   :: "r"(xd + r * L::x_row + ((c ^ (r & L::x_swz)) << 4)),
                      "l"(x + r * in + 2 * p0 + 8 * c));
    }
    if (i % spg == spg - 1) {   // the stage ends a group: its scales
      const float* src = s4 + (g0 + i / spg) * out + c0;
      const uint32_t sd = xd + (uint32_t)L::x_bytes;
      if constexpr (ALIGNED) {
        const bool ok = c0 + 4 * gtid < out;
        vstar::cp_async16(sd + 16 * gtid, ok ? src + 4 * gtid : s4, ok);
      } else {
#pragma unroll
        for (int it = 0; it < L::cols / GT; ++it) {
          const int col = gtid + GT * it;
          const bool ok = c0 + col < out;
          vstar::cp_async4(sd + 4 * col, ok ? src + col : s4, ok);
        }
      }
    }
  };

  // 16 bytes (this warp's columns 16g .. 16g + 15) of ring row r of the
  // stage at sw; p is the row's packed-row index
  auto row_bytes = [&](const unsigned char* sw, int r, long long p, uint32_t (&w)[4]) {
    if constexpr (ALIGNED) {
      const uint4 v = *reinterpret_cast<const uint4*>(sw + r * L::w_row + wc * kDcCols +
                                                      ((g ^ ((r & 3) << 1)) << 4));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      const int sh = (int)(reinterpret_cast<uintptr_t>(q4 + p * out + c0) & 15);
      const uint32_t* base = reinterpret_cast<const uint32_t*>(sw + r * L::w_row) +
                             (sh >> 2) + 32 * wc + 4 * g;
      uint32_t v[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) v[j] = base[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = __funnelshift_r(v[j], v[j + 1], 8 * (sh & 3));
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_st) load_stage(st, st);
    vstar::cp_async_commit();
  }
  float acc[8][NT][4], part[8][NT][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = part[t][nt][e] = 0.f;

  for (int i = 0; i < n_st; ++i) {
    vstar::cp_async_wait<STAGES - 2>();
    split_sync();
    if (i + STAGES - 1 < n_st) load_stage(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    vstar::cp_async_commit();
    const unsigned char* sw = ring + (i % STAGES) * L::stage;
    const long long p0 = p_first + (long long)i * SROWS;
    if (i % spg == 0) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[t][nt][e] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < ((PF & 4) ? 0 : SROWS / 8); ++s) {   // k-steps of 16 inputs
      uint32_t wa[4], wb[4];
      row_bytes(sw, 8 * s + t4, p0 + 8 * s + t4, wa);
      row_bytes(sw, 8 * s + 4 + t4, p0 + 8 * s + 4 + t4, wb);
      uint32_t bx[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + g;
        const unsigned char* xr = sw + L::w_bytes + n * L::x_row + 4 * t4;
        const int sw_n = n & L::x_swz;
        const uint32_t x0 = *reinterpret_cast<const uint32_t*>(xr + (((2 * s) ^ sw_n) << 4));
        const uint32_t x1 =
            *reinterpret_cast<const uint32_t*>(xr + (((2 * s + 1) ^ sw_n) << 4));
        bx[nt][0] = __byte_perm(x0, x1, 0x5410);
        bx[nt][1] = __byte_perm(x0, x1, 0x7632);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // [row p col 4j, row p col 4j+1, row p' col 4j, row p' col 4j+1]
        const uint32_t lo = __byte_perm(wa[j], wb[j], 0x5410);
        const uint32_t hi = __byte_perm(wa[j], wb[j], 0x7632);
        const uint32_t a0[4] = {nibbles_bf16x2(lo), nibbles_bf16x2(lo >> 8),
                                nibbles_bf16x2(lo >> 4), nibbles_bf16x2(lo >> 12)};
        const uint32_t a1[4] = {nibbles_bf16x2(hi), nibbles_bf16x2(hi >> 8),
                                nibbles_bf16x2(hi >> 4), nibbles_bf16x2(hi >> 12)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          vstar::mma_bf16(part[2 * j][nt], a0, bx[nt][0], bx[nt][1]);
          vstar::mma_bf16(part[2 * j + 1][nt], a1, bx[nt][0], bx[nt][1]);
        }
      }
    }
    if (i % spg == spg - 1) {   // the group's dot, times its scales
      const float4* sc = reinterpret_cast<const float4*>(sw + L::w_bytes + L::x_bytes) +
                         32 * wc + 4 * g;
      float s16[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = sc[j];
        s16[4 * j] = v.x; s16[4 * j + 1] = v.y; s16[4 * j + 2] = v.z; s16[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[t][nt][0] = fmaf(part[t][nt][0], s16[2 * t], acc[t][nt][0]);
          acc[t][nt][1] = fmaf(part[t][nt][1], s16[2 * t], acc[t][nt][1]);
          acc[t][nt][2] = fmaf(part[t][nt][2], s16[2 * t + 1], acc[t][nt][2]);
          acc[t][nt][3] = fmaf(part[t][nt][3], s16[2 * t + 1], acc[t][nt][3]);
        }
    }
  }
  vstar::cp_async_wait<0>();
  split_sync();   // the k-split's warps are done with its ring
  // this warp's partial [RB][128] f32, in its k-split's ring
  float* red = reinterpret_cast<float*>(ring) + wc * RB * kDcCols;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * nt + 2 * t4 + (e & 1)) * kDcCols + 16 * g + 2 * t + (e >> 1)] = acc[t][nt][e];
  if constexpr ((PF & 32) != 0) return;
  cluster.sync();
  // the splits of this strip, in order (block rank, then k-split), for
  // this block's share of the strip's outputs
  for (int idx = rank * NTHR + (int)threadIdx.x; idx < rows * L::cols; idx += csize * NTHR) {
    const int r = idx / L::cols, col = idx % L::cols;
    const int off = (col / kDcCols) * RB * kDcCols + r * kDcCols + col % kDcCols;
    // all the remote reads first (they overlap), then the sum in order
    float v[kDcMaxCluster][WK];
#pragma unroll
    for (int blk = 0; blk < kDcMaxCluster; ++blk)
      if (blk < csize) {
        const float* part_b = cluster.map_shared_rank(reinterpret_cast<float*>(dc_smem), blk);
#pragma unroll
        for (int k = 0; k < WK; ++k) v[blk][k] = part_b[k * (L::ring / 4) + off];
      }
    float sum = 0.f;
#pragma unroll
    for (int blk = 0; blk < kDcMaxCluster; ++blk)
      if (blk < csize)
#pragma unroll
        for (int k = 0; k < WK; ++k) sum += v[blk][k];
    if (c0 + col < out) y[r * out + c0 + col] = __float2bfloat16(sum);
  }
  cluster.sync();   // no block leaves while its partials are read
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

// Opts a kernel into its dynamic shared memory once per process.
template <auto Kernel>
cudaError_t prepare(size_t smem) {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

// K5 at R <= 16: strips of 128 columns, `cluster` blocks (4 splits each)
// per strip, one cluster per strip.
template <int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
int launch_k5_decode(const bf16* x, const uint8_t* q4, const float* s4, bf16* y,
                     int rows, long long in, long long out, int group, int cluster,
                     cudaStream_t st) {
  constexpr size_t smem = DecodeSmem<RB, ALIGNED, SROWS, STAGES, WC, WK, PF>::bytes;
  constexpr auto kernel = int4_decode_kernel<RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  if (group % (2 * SROWS) || cluster < 1 || cluster > kDcMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long strips = (out + kDcCols * WC - 1) / (kDcCols * WC);
  const long long splits = (long long)WK * cluster;
  const int per = (int)((in / group + splits - 1) / splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(strips * cluster));
  cfg.blockDim = dim3(WC * WK * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, q4, s4, y, rows, in, out, group, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Build facts of one decode-row instantiation: {registers, local (spill)
// bytes, static smem, dynamic smem, resident blocks per SM, threads}.
template <int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
int info_k5(long long* vals) {
  constexpr size_t smem = DecodeSmem<RB, ALIGNED, SROWS, STAGES, WC, WK, PF>::bytes;
  constexpr auto kernel = int4_decode_kernel<RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  cudaError_t err = prepare<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WC * WK * 32, smem);
  vals[0] = a.numRegs;
  vals[1] = (long long)a.localSizeBytes;
  vals[2] = (long long)a.sharedSizeBytes;
  vals[3] = (long long)smem;
  vals[4] = blocks;
  vals[5] = WC * WK * 32;
  return (int)err;
}

template <int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
int occupancy_k5(int* blocks) {
  constexpr size_t smem = DecodeSmem<RB, ALIGNED, SROWS, STAGES, WC, WK, PF>::bytes;
  constexpr auto kernel = int4_decode_kernel<RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  cudaError_t err = prepare<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, WC * WK * 32, smem);
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

// Blocks of K6's decode-row launch for `rows` (<= 16) and `vec` that
// one SM holds at `smem` bytes of dynamic shared memory, into *blocks.
extern "C" int vstar_int4_occupancy(long long rows, long long vec, long long smem,
                                    void* blocks) {
  auto* b = static_cast<int*>(blocks);
  switch (row_bucket(rows)) {
    case 1: return occupancy_k6<1>(vec, smem, b);
    case 2: return occupancy_k6<2>(vec, smem, b);
    case 4: return occupancy_k6<4>(vec, smem, b);
    case 8: return occupancy_k6<8>(vec, smem, b);
    default: return occupancy_k6<16>(vec, smem, b);
  }
}

// Blocks of K5's decode-row kernel (rows <= 16) that one SM holds, into
// *blocks; `aligned` as for vstar_int4_matmul.
extern "C" int vstar_int4_decode_occupancy(long long rows, long long aligned, void* blocks) {
  auto* b = static_cast<int*>(blocks);
  if (rows <= 8) return aligned ? occupancy_k5<8, true, VSTAR_K5_DECODE>(b) : occupancy_k5<8, false, VSTAR_K5_DECODE>(b);
  return aligned ? occupancy_k5<16, true, VSTAR_K5_DECODE>(b) : occupancy_k5<16, false, VSTAR_K5_DECODE>(b);
}

// Build facts of K5's i-th decode-row instantiation (rows 8 / 16,
// aligned / ragged), as vstar_attention_kernel_info reports them; -1 past
// the last.
extern "C" int vstar_int4_kernel_info(int i, const char** name, long long* vals) {
  switch (i) {
    case 0: *name = "int4_decode<8, aligned>"; return info_k5<8, true, VSTAR_K5_DECODE>(vals);
    case 1: *name = "int4_decode<16, aligned>"; return info_k5<16, true, VSTAR_K5_DECODE>(vals);
    case 2: *name = "int4_decode<8, ragged>"; return info_k5<8, false, VSTAR_K5_DECODE>(vals);
    case 3: *name = "int4_decode<16, ragged>"; return info_k5<16, false, VSTAR_K5_DECODE>(vals);
  }
  return -1;
}

// K5: y [rows, out] bf16 = x [rows, in] bf16 @ dequant(q4 [in/2, out],
// s4 [in/group, out]); contiguous operands, x 16-byte aligned, group
// even, in % 8 == 0. rows <= 16 takes the tensor-core decode rows
// (`cluster` 1..8 blocks per 128-column strip; group % 64 == 0; aligned:
// out % 16 == 0 and q4, s4 16-byte aligned), rows > 16 the tensor-core
// tiles (cluster unused; aligned: 16-byte weight loads).
extern "C" int vstar_int4_matmul(const void* x, const void* q4, const void* s4, void* y,
                                 long long rows, long long in, long long out,
                                 long long group, long long cluster, long long aligned,
                                 void* stream) {
  if (group < 2 || group % 2 || in % group || in % 8 || rows < 1)
    return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const bf16*>(x);
  auto* qb = static_cast<const uint8_t*>(q4);
  auto* sf = static_cast<const float*>(s4);
  auto* yb = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (rows > vstar::kMaxRows) {
    dim3 grid((unsigned)((out + kTn - 1) / kTn), (unsigned)((rows + kTm - 1) / kTm));
    if (aligned)
      int4_matmul_tc_kernel<true><<<grid, kTcThreads, 0, st>>>(xb, qb, sf, yb, rows, in,
                                                               out, (int)group);
    else
      int4_matmul_tc_kernel<false><<<grid, kTcThreads, 0, st>>>(xb, qb, sf, yb, rows, in,
                                                                out, (int)group);
    return (int)cudaGetLastError();
  }
  const int r = (int)rows, g = (int)group, c = (int)cluster;
  if (rows <= 8)
    return aligned ? launch_k5_decode<8, true, VSTAR_K5_DECODE>(xb, qb, sf, yb, r, in, out, g, c, st)
                   : launch_k5_decode<8, false, VSTAR_K5_DECODE>(xb, qb, sf, yb, r, in, out, g, c, st);
  return aligned ? launch_k5_decode<16, true, VSTAR_K5_DECODE>(xb, qb, sf, yb, r, in, out, g, c, st)
                 : launch_k5_decode<16, false, VSTAR_K5_DECODE>(xb, qb, sf, yb, r, in, out, g, c, st);
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
