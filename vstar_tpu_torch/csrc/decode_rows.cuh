// The tensor-core decode rows (R <= 16) of the quantized-weight matmuls,
// shared by K5 (int4_matmul.cu: two's-complement nibbles with one f32
// scale per group and column) and K3/K4 (int8_matvec.cu: int8 with one f32
// scale per column). Both are bound by the bytes of the weight, so one
// kernel template streams them, in either format.
//
// y^T [OUT, R] = W^T x^T on mma.sync.m16n8k16 (bf16 in, f32 accumulate):
// the output columns are the M rows, the activation rows the N columns
// (8 per n-tile, two at 16 rows), the inputs the K depth. The product does
// not depend on the order of the output columns or of the inputs within a
// k-step, so both are permuted to fit the bytes as they lie:
//   A  thread (g, t4) of a warp reads, per k-step of 16 inputs, 16
//      neighbouring columns (16g .. 16g + 15 of the warp's 128) of a few
//      weight rows, and __byte_perm pairs the bytes of two rows of one
//      column, so that one 32-bit register holds two inputs of that column:
//      the k-pair (2t4, 2t4 + 1) or (8 + 2t4, 9 + 2t4) of mma. M row g of
//      m-tile T is column 16g + 2T, M row g + 8 is column 16g + 2T + 1.
//        int4  packed rows t4 and 4 + t4 (inputs 2p, 2p + 1 each): their
//              low nibbles are one k-pair, their high nibbles the other.
//        int8  rows 2t4, 8 + 2t4 (one k-pair) and 2t4 + 1, 9 + 2t4 (the
//              other), the same inputs as int4 takes.
//   unpack  no integer-to-float conversion. int4: lop3 masks two nibbles
//      into the mantissas of bf16x2 128 + (n ^ 8) (the XOR included), and
//      one fma.rn.bf16x2 subtracts 136, exactly. int8 (a byte does not fit
//      a bf16 mantissa): f32 2^23 + (b ^ 0x80) by one byte permute, minus
//      2^23 + 128, and one cvt.rn.bf16x2.f32 per pair, exactly. (Splitting
//      each byte into two nibble k-steps against x and 16 x, also exact,
//      measured no faster: PERF.md.)
//   B  x in the same input order: the pair words (2t4, 2t4 + 1) and (8 +
//      2t4, 9 + 2t4) of row g, re-paired by __byte_perm.
// int4: per group the f32 mma sums are the group dot; it is scaled by s4 in
// f32 and added to the accumulator, as int4_matmul_kernel_math does for at
// most 16 rows. int8: the f32 mma sums are the whole dot, and the column
// scale is applied once, after the split reduction (y = (x q) s, as the
// TPU kernel computes it).
//
// Streaming: a block of WC * WK warps owns a strip of 128 * WC columns;
// each group of WC warps a k-split of whole units (int4: groups; int8:
// ring stages), streamed through a split-private STAGES-deep cp.async ring
// (SROWS weight rows, their inputs of x, and for int4 at a group's end its
// scales per stage), so each SM keeps its blocks' stages in flight. The
// blocks of one strip form a thread-block cluster (1, 2, 4 or 8 blocks,
// from the host's plan). After the stream each warp leaves its partial
// [R, 128] f32 in its own ring; each block adds its k-splits in order and
// stores the sums into the receive slots of the blocks that own those
// outputs (distributed shared memory); after one cluster barrier every
// block adds its slots in rank order and writes y in bf16. No workspace,
// no second launch, no atomics.
//
// Ragged rows (OUT % 16, the 32003-wide lm_head, or unaligned operands):
// a row's 128 columns are copied as the nine aligned 16-byte chunks that
// cover them (chunks outside the tensor are zero-filled), and a thread
// funnel-shifts its 16 bytes out of five words by the row's byte offset.
#pragma once

#include <climits>
#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace {

using vstar::bf16;
namespace cg = cooperative_groups;

constexpr int kDcCols = 128;                // columns of a warp

// Weight formats of the decode rows.
constexpr int kFmtInt4 = 0;   // K5: packed nibbles, group scales
constexpr int kFmtInt8 = 1;   // K3: int8, column scales

// Opts a kernel into its dynamic shared memory once per process.
template <auto Kernel>
cudaError_t prepare(size_t smem) {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

// A k-split's ring, shared by its WC warps: STAGES stages of SROWS weight
// rows (int4: packed rows) of the block's 128 * WC columns, their inputs of
// x for RB rows, and (int4) the scales of the group a stage ends.
// PF: the L2 prefetch size the weight copies ask for (0: none, 1: 128
// bytes, 2: 256 bytes); kernel_probe.py's timing breakdown adds 4 (no
// products), 8 (no weight copies), 16 (nothing at all), 32 (no reduction
// of the splits), and for int8 128 (the unpack without the mma) or 256
// (the mma on raw bytes), which give wrong results.
template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
struct DecodeSmem {
  static constexpr bool int8 = FMT != kFmtInt4;
  // blocks a strip's cluster may have: 8 (portable) for int4; 16 (the
  // H100's non-portable limit) for int8, whose 4096-wide outputs have
  // only 32 strips to spread over 132 SMs
  static constexpr int max_cluster = int8 ? 16 : 8;
  static constexpr int cols = kDcCols * WC;                         // strip
  static constexpr int w_chunks = cols / 16 + (ALIGNED ? 0 : 1);   // per row
  static constexpr int w_row = w_chunks * 16;                       // bytes
  static constexpr size_t w_bytes = (size_t)SROWS * w_row;
  static constexpr int k_rows = int8 ? 16 : 8;      // weight rows a k-step
  static constexpr int x_row = SROWS * (int8 ? 2 : 4);              // bytes
  static constexpr int x_chunks = x_row / 16;
  static constexpr int x_swz = (x_chunks < 8 ? x_chunks : 8) - 1;
  static constexpr size_t x_bytes = (size_t)RB * x_row;
  static constexpr size_t s_bytes = int8 ? 0 : (size_t)cols * 4;
  static constexpr size_t stage = w_bytes + x_bytes + s_bytes;
  static constexpr size_t ring = STAGES * stage;
  // int8: the strip's column scales, copied at the start, read at the end
  static constexpr size_t col_scales = int8 ? (size_t)cols * 4 : 0;
  // the split reduction's receive slots: a block's share of the strip's
  // RB x cols outputs from each block of the cluster
  static constexpr size_t recv = ((size_t)RB * cols + max_cluster) * 4;
  static constexpr size_t bytes = WK * ring + col_scales + recv;
  static_assert(SROWS % k_rows == 0 && SROWS >= 16 && STAGES >= 3, "decode ring shape");
  static_assert((size_t)WC * RB * kDcCols * 4 <= ring, "the partials fit the ring");
};

// The XOR that places 16-byte chunk c of ring row r at c ^ swizzle, so
// that a quarter-warp's reads (4 rows, 2 chunks) miss each other: int4
// reads rows t4 (and 4 + t4), int8 rows 2t4 (and 2t4 + 1, 8 + 2t4, ...).
template <int FMT>
__device__ __forceinline__ int row_swizzle(int r) {
  return FMT == kFmtInt4 ? (r & 3) << 1 : r & 6;
}

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

// Two signed nibbles of v (bits 0-3 and 16-19, two's-complement) as bf16x2.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  uint32_t r;
  // (v & 0x000F000F) ^ 0x43084308: bf16 128 + (n ^ 8) in each half
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(r) : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  // * 1 - 136: n, exactly
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Byte k of u, where u is a word of int8 bytes XORed with 0x80808080
// (each byte b + 128), as the f32 value b: 2^23 + (b + 128) - (2^23 + 128);
// magic holds 0x4B000000 (the exponent bytes of 2^23).
__device__ __forceinline__ float byte_f32(uint32_t u, int k, uint32_t magic) {
  return __uint_as_float(__byte_perm(u, magic, 0x7440 | k)) - 8388736.f;
}

// 0x4B000000 in a register the compiler cannot rematerialise from a
// uniform one before every byte permute.
__device__ __forceinline__ uint32_t magic_2p23() {
  uint32_t m;
  asm volatile("mov.b32 %0, 0x4B000000;" : "=r"(m));
  return m;
}

// y [rows, out] = x [rows, in] @ W, W in format FMT:
//   int4  q packed [in/2, out], s4 [in/group, out]; group % (2 SROWS) == 0
//   int8  q [in, out], s [out]; x rows are xs apart (xs % 8 == 0, xs >= in,
//         x zero past in)
// Units: int4 groups, int8 ring stages of SROWS rows; each k-split takes
// `per` of them.
template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
__global__ void __launch_bounds__(WC * WK * 32)
    decode_rows_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q,
                       const float* __restrict__ s, bf16* __restrict__ y, int rows,
                       long long in, long long out, long long xs, int group, int per) {
  using L = DecodeSmem<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  constexpr bool I8 = L::int8;
  constexpr int NT = RB / 8, GT = WC * 32, NTHR = WC * WK * 32;
  if constexpr ((PF & 16) != 0) return;
  extern __shared__ __align__(128) unsigned char dc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp % WC, wk = warp / WC, gtid = wc * 32 + lane;
  const int g = lane >> 2, t4 = lane & 3;
  const long long c0 = (long long)(blockIdx.x / csize) * L::cols;   // the strip's
  const long long nrows = I8 ? in : in / 2;                        // weight rows
  const long long ng = I8 ? (in + SROWS - 1) / SROWS : in / group;  // units
  const long long g0 = min(ng, (long long)(rank * WK + wk) * per);
  const long long g1 = min(ng, g0 + per);
  const int spg = I8 ? 1 : group / (2 * SROWS);   // ring stages per unit
  const int n_st = (int)(g1 - g0) * spg;
  const long long p_first = g0 * (I8 ? SROWS : group / 2);   // the split's first row
  unsigned char* ring = dc_smem + wk * L::ring;
  const uint32_t ring_u = vstar::smem_u32(ring);
  const uint8_t* q_end = q + nrows * out;
  // the k-split's WC warps move through the ring together
  auto split_sync = [&]() {
    if constexpr (WC == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" :: "r"(1 + wk), "r"(GT) : "memory");
  };

  // The copies' addresses, worked out once: this thread's 16-byte chunk
  // wq_c of ring rows wq_r0 + 4 it (aligned weights), and its x chunks
  // (row, chunk) = divmod(gtid + GT j, x_chunks); a stage only adds its
  // offset.
  constexpr int CPR = L::cols / 16, XJ = (RB * L::x_chunks + GT - 1) / GT;
  static_assert(GT % CPR == 0 && GT / CPR == 4, "a pass copies 4 rows");
  const int wq_c = gtid % CPR, wq_r0 = gtid / CPR;
  const bool wq_col = c0 + 16 * wq_c < out;
  const uint8_t* wq_src = q + (p_first + wq_r0) * out + c0 + 16 * wq_c;
  const long long wq_step = 4 * out, wq_stage = (long long)SROWS * out;
  const int wq_left = (int)min(nrows - p_first - wq_r0, (long long)INT_MAX);
  uint32_t wq_dst[2];   // by the parity of it (int8 swizzles rows r & 6)
#pragma unroll
  for (int par = 0; par < 2; ++par)
    wq_dst[par] = wq_r0 * L::w_row + (wq_c >> 3) * kDcCols +
                  (((wq_c & 7) ^ row_swizzle<FMT>(wq_r0 + 4 * par)) << 4);
  const bf16* xq_src[XJ];
  uint32_t xq_dst[XJ];
  int xq_c8[XJ];
  bool xq_ok[XJ];
#pragma unroll
  for (int j = 0; j < XJ; ++j) {
    const int idx = gtid + GT * j, r = idx / L::x_chunks, c = idx % L::x_chunks;
    xq_ok[j] = r < rows;
    xq_src[j] = x + (xq_ok[j] ? r : 0) * xs + 8 * c;
    xq_dst[j] = r * L::x_row + ((c ^ (r & L::x_swz)) << 4);
    xq_c8[j] = 8 * c;
  }

  auto load_stage = [&](int i, int slot) {
    const uint32_t dst = ring_u + slot * (uint32_t)L::stage;
    const long long p0 = p_first + (long long)i * SROWS;
    if constexpr ((PF & 8) != 0) {
    } else if constexpr (ALIGNED) {
      // rows of 128 * WC contiguous bytes; 16-byte chunk c of row r goes
      // to warp slice c / 8 at (c % 8) ^ row_swizzle(r)
      const uint8_t* src = wq_src + i * wq_stage;
#pragma unroll
      for (int it = 0; it < SROWS / 4; ++it, src += wq_step) {
        const bool ok = wq_col && (!I8 || i * SROWS + 4 * it < wq_left);
        cp_async16_pf<PF>(dst + wq_dst[it & 1] + it * 4 * L::w_row, ok ? src : q, ok);
      }
    } else {
      // the aligned 16-byte chunks that cover each row's 128 * WC columns
      for (int idx = gtid; idx < SROWS * L::w_chunks; idx += GT) {
        const int r = idx / L::w_chunks, c = idx % L::w_chunks;
        const uintptr_t a =
            (reinterpret_cast<uintptr_t>(q + (p0 + r) * out + c0) & ~(uintptr_t)15) + 16 * c;
        const bool ok = a + 16 > reinterpret_cast<uintptr_t>(q) &&
                        a < reinterpret_cast<uintptr_t>(q_end) && (!I8 || p0 + r < nrows);
        cp_async16_pf<PF>(dst + r * L::w_row + 16 * c,
                          ok ? reinterpret_cast<const void*>(a) : q, ok);
      }
    }
    // x rows [0, rows), the stage's inputs: chunk c of row r at c ^ (r %
    // 8) (fewer chunks: r modulo their count)
    const uint32_t xd = dst + (uint32_t)L::w_bytes;
    const long long k0 = I8 ? p0 : 2 * p0;
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      if (!xq_ok[j]) continue;
      // through L1 (.ca): every k-split of every strip on the SM reads the
      // same x, which through L2 alone makes one hot line per stage
      if constexpr (I8) {   // zeros past the last input
        const bool ok = k0 + xq_c8[j] < xs;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(xd + xq_dst[j]), "l"(ok ? xq_src[j] + k0 : x), "r"(ok ? 16 : 0));
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                     :: "r"(xd + xq_dst[j]), "l"(xq_src[j] + k0));
      }
    }
    if constexpr (!I8) {
      if (i % spg == spg - 1) {   // the stage ends a group: its scales
        const float* src = s + (g0 + i / spg) * out + c0;
        const uint32_t sd = xd + (uint32_t)L::x_bytes;
        if constexpr (ALIGNED) {
          const bool ok = c0 + 4 * gtid < out;
          vstar::cp_async16(sd + 16 * gtid, ok ? src + 4 * gtid : s, ok);
        } else {
#pragma unroll
          for (int it = 0; it < L::cols / GT; ++it) {
            const int col = gtid + GT * it;
            const bool ok = c0 + col < out;
            vstar::cp_async4(sd + 4 * col, ok ? src + col : s, ok);
          }
        }
      }
    }
  };

  // 16 bytes (this warp's columns 16g .. 16g + 15) of ring row r of the
  // stage at sw; p is the row's index in q
  auto row_bytes = [&](const unsigned char* sw, int r, long long p, uint32_t (&w)[4]) {
    if constexpr (ALIGNED) {
      const uint4 v = *reinterpret_cast<const uint4*>(sw + r * L::w_row + wc * kDcCols +
                                                      ((g ^ row_swizzle<FMT>(r)) << 4));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      const int sh = (int)(reinterpret_cast<uintptr_t>(q + p * out + c0) & 15);
      const uint32_t* base = reinterpret_cast<const uint32_t*>(sw + r * L::w_row) +
                             (sh >> 2) + 32 * wc + 4 * g;
      uint32_t v[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) v[j] = base[j];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = __funnelshift_r(v[j], v[j + 1], 8 * (sh & 3));
    }
  };

  float* col_scale = reinterpret_cast<float*>(dc_smem + WK * L::ring);
  if constexpr (I8) {   // with the first stage's copies
    if (wk == 0)
      for (int col = gtid; col < L::cols; col += GT) {
        const bool ok = c0 + col < out;
        vstar::cp_async4(vstar::smem_u32(col_scale + col), ok ? s + c0 + col : s, ok);
      }
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_st) load_stage(st, st);
    vstar::cp_async_commit();
  }
  // int4 sums each group in part and adds it, scaled, to acc; int8 sums
  // into acc directly
  float acc[8][NT][4], part[8][NT][4];
  float (&sum)[8][NT][4] = I8 ? acc : part;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = part[t][nt][e] = 0.f;

  uint32_t magic = 0;
  if constexpr (I8) magic = magic_2p23();
  for (int i = 0; i < n_st; ++i) {
    vstar::cp_async_wait<STAGES - 2>();
    split_sync();
    if (i + STAGES - 1 < n_st) load_stage(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    vstar::cp_async_commit();
    const unsigned char* sw = ring + (i % STAGES) * L::stage;
    const long long p0 = p_first + (long long)i * SROWS;
    if constexpr (!I8) {
      if (i % spg == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[t][nt][e] = 0.f;
      }
    }
#pragma unroll
    for (int st = 0; st < ((PF & 4) ? 0 : SROWS / L::k_rows); ++st) {   // k-steps of 16 inputs
      uint32_t bx[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + g;
        const unsigned char* xr = sw + L::w_bytes + n * L::x_row + 4 * t4;
        const int sw_n = n & L::x_swz;
        const uint32_t x0 = *reinterpret_cast<const uint32_t*>(xr + (((2 * st) ^ sw_n) << 4));
        const uint32_t x1 =
            *reinterpret_cast<const uint32_t*>(xr + (((2 * st + 1) ^ sw_n) << 4));
        bx[nt][0] = __byte_perm(x0, x1, 0x5410);
        bx[nt][1] = __byte_perm(x0, x1, 0x7632);
      }
      if constexpr (!I8) {
        uint32_t wa[4], wb[4];
        row_bytes(sw, 8 * st + t4, p0 + 8 * st + t4, wa);
        row_bytes(sw, 8 * st + 4 + t4, p0 + 8 * st + 4 + t4, wb);
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
      } else {
        // rows 2t4 (A) and 8 + 2t4 (B) make the k-pair of bx[.][0], rows
        // 2t4 + 1 (C) and 9 + 2t4 (D) that of bx[.][1]
        const int r0 = 16 * st + 2 * t4;
        uint32_t wa[4], wb[4], wc4[4], wd[4];
        row_bytes(sw, r0, p0 + r0, wa);
        row_bytes(sw, r0 + 8, p0 + r0 + 8, wb);
        row_bytes(sw, r0 + 1, p0 + r0 + 1, wc4);
        row_bytes(sw, r0 + 9, p0 + r0 + 9, wd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t ua = wa[j] ^ 0x80808080u, ub = wb[j] ^ 0x80808080u;
          const uint32_t uc = wc4[j] ^ 0x80808080u, ud = wd[j] ^ 0x80808080u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // m-tile 2j + h: columns 4j + 2h, + 1
            uint32_t a[4];
            if constexpr ((PF & 256) != 0) {
              a[0] = ua; a[1] = ub; a[2] = uc; a[3] = ud;
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {   // k-pairs of rows (A, B), (C, D)
                const uint32_t lo = e ? uc : ua, hi = e ? ud : ub;
                a[2 * e] = vstar::pack_bf16(byte_f32(lo, 2 * h, magic),
                                            byte_f32(hi, 2 * h, magic));
                a[2 * e + 1] = vstar::pack_bf16(byte_f32(lo, 2 * h + 1, magic),
                                                byte_f32(hi, 2 * h + 1, magic));
              }
            }
            if constexpr ((PF & 128) != 0) {
              acc[2 * j + h][0][0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);
            } else {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                vstar::mma_bf16(acc[2 * j + h][nt], a, bx[nt][0], bx[nt][1]);
            }
          }
        }
      }
    }
    if constexpr (!I8) {
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
            acc[t][nt][0] = fmaf(sum[t][nt][0], s16[2 * t], acc[t][nt][0]);
            acc[t][nt][1] = fmaf(sum[t][nt][1], s16[2 * t], acc[t][nt][1]);
            acc[t][nt][2] = fmaf(sum[t][nt][2], s16[2 * t + 1], acc[t][nt][2]);
            acc[t][nt][3] = fmaf(sum[t][nt][3], s16[2 * t + 1], acc[t][nt][3]);
          }
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
  __syncthreads();   // every k-split's partial is in place
  // Push: the block's sum over its k-splits (in order) of each output of
  // the strip goes to the receive slot (this rank's) of the block that
  // owns the output; outputs are owned in `chunk`-long runs by rank.
  const int n_out = rows * L::cols;
  const int chunk = (n_out + csize - 1) / csize;
  float* recv = reinterpret_cast<float*>(dc_smem + WK * L::ring + L::col_scales);
  for (int idx = threadIdx.x; idx < n_out; idx += NTHR) {
    const int r = idx / L::cols, col = idx % L::cols;
    const int off = (col / kDcCols) * RB * kDcCols + r * kDcCols + col % kDcCols;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < WK; ++k) v += reinterpret_cast<const float*>(dc_smem + k * L::ring)[off];
    cluster.map_shared_rank(recv, idx / chunk)[rank * chunk + idx % chunk] = v;
  }
  cluster.sync();   // every push has landed (arrive.release, wait.acquire)
  // this block's outputs: the pushed sums in rank order; nothing remote is
  // touched after the barrier, so no block waits for another to leave
  for (int li = threadIdx.x; li < chunk; li += NTHR) {
    const int idx = rank * chunk + li;
    if (idx >= n_out) break;
    const int r = idx / L::cols, col = idx % L::cols;
    float total = 0.f;
    for (int src = 0; src < csize; ++src) total += recv[src * chunk + li];
    if (c0 + col < out) {
      if constexpr (I8) total *= col_scale[col];   // the column scale
      y[r * out + c0 + col] = __float2bfloat16(total);
    }
  }
}

// Strips of 128 * WC columns, `cluster` blocks (WK splits each) per strip,
// one cluster per strip.
template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
int launch_decode(const bf16* x, const uint8_t* q, const float* s, bf16* y, int rows,
                  long long in, long long out, long long xs, int group, int cluster,
                  cudaStream_t st) {
  using L = DecodeSmem<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  constexpr auto kernel = decode_rows_kernel<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  if (cluster < 1 || cluster > L::max_cluster || (!L::int8 && group % (2 * SROWS)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<kernel>(L::bytes);
  if (err != cudaSuccess) return (int)err;
  if constexpr (L::max_cluster > 8) {
    static const cudaError_t np =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (np != cudaSuccess) return (int)np;
  }
  const long long strips = (out + L::cols - 1) / L::cols;
  const long long splits = (long long)WK * cluster;
  const long long units = L::int8 ? (in + SROWS - 1) / SROWS : in / group;
  const int per = (int)((units + splits - 1) / splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(strips * cluster));
  cfg.blockDim = dim3(WC * WK * 32);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, q, s, y, rows, in, out, xs, group, per);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Build facts of one kernel: {registers, local (spill) bytes, static
// smem, dynamic smem, resident blocks per SM, threads}.
template <auto Kernel>
int kernel_facts(size_t smem, int threads, long long* vals) {
  cudaError_t err = prepare<Kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, Kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel, threads, smem);
  vals[0] = a.numRegs;
  vals[1] = (long long)a.localSizeBytes;
  vals[2] = (long long)a.sharedSizeBytes;
  vals[3] = (long long)smem;
  vals[4] = blocks;
  vals[5] = threads;
  return (int)err;
}

template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
int info_decode(long long* vals) {
  using L = DecodeSmem<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  return kernel_facts<decode_rows_kernel<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>>(
      L::bytes, WC * WK * 32, vals);
}

// Resident blocks per SM of one decode-row instantiation, into *blocks.
template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF>
int occupancy_decode(int* blocks) {
  long long vals[6];
  const int err = info_decode<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>(vals);
  *blocks = (int)vals[4];
  return err;
}

// The 8- or 16-row instantiation (aligned or ragged) of one decode-row
// shape: launches it, or with info set reports its build facts into vals.
template <int FMT, int SROWS, int STAGES, int WC, int WK, int PF>
int run_decode(bool info, int rows, bool aligned, long long* vals, const bf16* x,
               const uint8_t* q, const float* s, bf16* y, long long in, long long out,
               long long xs, int group, int cluster, cudaStream_t st) {
#define VSTAR_DECODE_CALL(RB, AL)                                                      \
  return info ? info_decode<FMT, RB, AL, SROWS, STAGES, WC, WK, PF>(vals)              \
              : launch_decode<FMT, RB, AL, SROWS, STAGES, WC, WK, PF>(x, q, s, y, rows, \
                                                                      in, out, xs, group, \
                                                                      cluster, st)
  if (rows > 8) {
    if (aligned) VSTAR_DECODE_CALL(16, true);
    VSTAR_DECODE_CALL(16, false);
  }
  if (aligned) VSTAR_DECODE_CALL(8, true);
  VSTAR_DECODE_CALL(8, false);
#undef VSTAR_DECODE_CALL
}

}  // namespace
