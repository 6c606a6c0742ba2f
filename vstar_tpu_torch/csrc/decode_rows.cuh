// The tensor-core decode rows (R <= 16) of the quantized-weight matmuls,
// shared by K5 (int4_matmul.cu: two's-complement nibbles with one f32
// scale per group and column), K3/K4 (int8_matvec.cu: int8 with one f32
// scale per column), K6 (int4_matmul.cu: K5's nibbles against int8
// activations) and P2-P4 (int4_variants.cu: K6 with another low-nibble
// unpack, K6 summed in row blocks, K6 on transposed storage). All are
// bound by the bytes of the weight, so one kernel template streams them,
// in any of these formats.
//
// y^T [OUT, R] = W^T x^T on mma.sync: the output columns are the M rows,
// the activation rows the N columns (8 per n-tile, two at 16 rows), the
// inputs the K depth. The product does not depend on the order of the
// output columns or of the inputs within a k-step, so both are permuted to
// fit the bytes as they lie.
//
// K5 and K3, m16n8k16 (bf16 in, f32 accumulate):
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
// K6, P2-P4 (W4A8), m16n8k32 (s8 in, s32 accumulate): an A register holds
// four inputs of one output column as 16 x nibble in int8, the high nibble
// b & 0xF0 and the low one (b << 4) & 0xF0, the TPU kernel's hi16 / lo16
// (vstar_tpu/kernels/int4_matmul.py:175-176). A register of 4 packed bytes
// of one column is two A registers by the two masks: its low nibbles are
// the k-slots 4t4 .. 4t4 + 3 of M row g (or g + 8), its high nibbles the
// k-slots 16 + 4t4 .. 16 + 4t4 + 3, so B (x, int8) holds the even inputs of
// 8 consecutive ones in b0 and the odd ones in b1 (two byte permutes).
//        W4A8   [IN/2, OUT]: a k-step is 16 packed rows; thread (g, t4)
//               reads columns 16g .. 16g + 15 of packed rows 4t4 .. 4t4 + 3
//               and transposes each 4 x 4 block of bytes (8 permutes) into
//               four column words; M rows as K5's.
//        W4A8T  [OUT, IN/2]: a ring row is one output's bytes of the stage,
//               so a word of it is already four packed inputs of one
//               output: thread (g, t4) reads words 2t4, 2t4 + 1 of outputs
//               16T + g (M row g of m-tile T) and 16T + 8 + g (M row g + 8)
//               and masks them, with no permute; k-step k of the stage uses
//               word 2t4 + k, so B takes inputs 8 (2t4 + k) .. + 7.
// The s32 mma sums of a group (128 inputs, 4 k-steps) are its exact dot of
// x with 16 x nibble (|d| <= 128 * 127 * 128 < 2^24, exact in f32); at the
// group's end it is converted, times s4 / 16 in f32, and added to the f32
// accumulator, as the TPU kernel does (:182-188). The activation scale is
// the caller's: K6's qdot passes the per-row sx, and the store multiplies
// by it and writes x's type; else the f32 sums are stored.
// P2's low-nibble unpacks (LO; W4A8 on q4 only), after the same transpose,
// each into K6's one accumulator of 16 x the dot:
//   ship  (b << 4) & 0xF0, K6's; mul  b * 16 per int8 byte (the same bytes
//         by another arithmetic): one m16n8k32 a k-step, K6's.
//   2and  the two masks b & 7 and b & 8, each times 16 in its byte: 16 (b &
//         7) <= 112 fits int8 and 16 (b & 8) is 0 or 0x80 = -128 = -16 * 8,
//         the subtraction for free. 16 (b & 7) takes the low k-slots of K6's
//         m16n8k32 (beside the high nibbles), 16 (b & 8) an m16n8k16 against
//         the even inputs: a third operand stream, 1.5x ship's products.
//   off   (b ^ 8) & 0xF = lo + 8, times 16 (<= 240: uint8, which mma takes
//         as A against int8 B) on an m16n8k16 against the even inputs, the
//         high nibbles on an s8 m16n8k16 against the odd ones; the
//         correction 8 * 16 sum(xe) of each row and group is one m16n8k16
//         of A = 1 on the same B fragments a k-step and n-tile (its C is the
//         sums, already in the accumulators' layout), not per column,
//         subtracted at the group's end.
//   Every unpack's group dot is K6's exact int32 dot, so its f32 sums are
//   K6's bit for bit. (Unscaled low parts in an accumulator of their own,
//   scaled by 16 at the group's end, held 27-34 more registers at 8 rows
//   and spilled at 16: measured 7-16 % slower than ship at one row.)
// P3 (W4A8R): K6 with its sums in blocks of `blk` groups, as the TPU's
// row blocks: each k-split takes whole blocks, sums a block's groups in
// its accumulator and adds the block's sum to its total in block order;
// the cluster adds the splits' totals in rank order.
//
// Streaming: a block of WC * WK warps owns a strip of 128 * WC columns;
// each group of WC warps a k-split of whole units (int4, W4A8: groups;
// int8: ring stages), streamed through a split-private STAGES-deep
// cp.async ring (SROWS weight rows (W4A8T: SROWS bytes of each of the
// strip's rows), their inputs of x, and at a group's end its scales per
// stage), so each SM keeps its blocks' stages in flight. The blocks of one
// strip form a thread-block cluster (1, 2, 4 or 8 blocks, from the host's
// plan). After the stream each warp leaves its partial [R, 128] f32 in its
// own ring; each block adds its k-splits in order and stores the sums into
// the receive slots of the blocks that own those outputs (distributed
// shared memory); after one cluster barrier every block adds its slots in
// rank order and writes y. No workspace, no second launch, no atomics.
// W4A8 launched after its row quantization (programmatic dependent launch)
// issues the weight copies of its first stages before it waits for x.
//
// Ragged rows (OUT % 16, the 32003-wide lm_head, or unaligned operands):
// a row's 128 columns are copied as the nine aligned 16-byte chunks that
// cover them (chunks outside the tensor are zero-filled), and a thread
// funnel-shifts its 16 bytes out of five words by the row's byte offset.
// W4A8T is read aligned only (its rows are IN/2 bytes, IN % 32 == 0).
#pragma once

#include <climits>
#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace vstar {

constexpr int kMaxRows = 16;   // activation rows of the decode rows

}  // namespace vstar

namespace {

using vstar::bf16;
namespace cg = cooperative_groups;

constexpr int kDcCols = 128;                // columns of a warp

// Weight formats of the decode rows.
constexpr int kFmtInt4 = 0;   // K5: packed nibbles, group scales, bf16 x
constexpr int kFmtInt8 = 1;   // K3: int8, column scales, bf16 x
constexpr int kFmtW4A8 = 2;   // K6: packed nibbles, group scales, int8 x
constexpr int kFmtW4A8T = 3;  // P4: K6's on transposed storage [OUT, IN/2]
// K6 on bf16 x, each block quantizing its rows itself (the row maxima
// read whole, then xq = rint(x / sx) at each B fragment): the alternative
// to a row-quantization launch, kept for kernel_probe.py's --w4a8-quant
constexpr int kFmtW4A8Q = 4;
// P3: K6 summed in blocks of groups, added in block order
constexpr int kFmtW4A8R = 5;

// The low-nibble unpacks of the W4A8 formats on q4 (P2's LO).
constexpr int kLoShip = 0;
constexpr int kLoMul = 1;
constexpr int kLoTwoAnd = 2;
constexpr int kLoOff = 3;

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
  static constexpr bool int8 = FMT == kFmtInt8;
  static constexpr bool w4a8 = FMT >= kFmtW4A8;
  static constexpr bool trans = FMT == kFmtW4A8T;
  static constexpr bool qx = FMT == kFmtW4A8Q;
  static constexpr bool blocked = FMT == kFmtW4A8R;
  // blocks a strip's cluster may have: 8 (portable) for int4; 16 (the
  // H100's non-portable limit) for int8 and W4A8, whose 4096-wide outputs
  // have only 32 (or, at 256 columns a strip, 16) strips for 132 SMs
  static constexpr int max_cluster = (int8 || w4a8) ? 16 : 8;
  static constexpr int cols = kDcCols * WC;                         // strip
  static constexpr int w_chunks = cols / 16 + (ALIGNED ? 0 : 1);   // per row
  // bytes of a ring row (W4A8T: one output's SROWS packed bytes)
  static constexpr int w_row = trans ? SROWS : w_chunks * 16;
  static constexpr size_t w_bytes = (size_t)(trans ? cols : SROWS) * w_row;
  // weight rows (W4A8T: bytes of a row) a k-step
  static constexpr int k_rows = FMT == kFmtInt4 ? 8 : 16;
  // bytes of x per activation row and stage: int4 and W4A8 take two
  // inputs a packed row, bf16 (int8 x: one byte)
  static constexpr int x_elem = (w4a8 && !qx) ? 1 : 2;
  static constexpr int x_row = SROWS * (int8 ? 1 : 2) * x_elem;
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
  // W4A8Q: each warp's row maxima, then the row scales
  static constexpr size_t qx_bytes = qx ? (size_t)(WC * WK + 1) * RB * 4 : 0;
  static constexpr size_t bytes = WK * ring + col_scales + recv + qx_bytes;
  static_assert(SROWS % k_rows == 0 && SROWS >= 16 && STAGES >= 3, "decode ring shape");
  static_assert(!trans || ALIGNED, "transposed storage is read aligned");
  static_assert((size_t)WC * RB * kDcCols * 4 <= ring, "the partials fit the ring");
};

// The XOR that places 16-byte chunk c of ring row r at c ^ swizzle, so
// that a quarter-warp's reads (4 rows, 2 chunks) miss each other: int4
// reads rows t4 (and 4 + t4), int8 rows 2t4 (and 2t4 + 1, 8 + 2t4, ...),
// W4A8 rows 4t4 + i of a k-step's 16.
template <int FMT>
__device__ __forceinline__ int row_swizzle(int r) {
  if constexpr (FMT == kFmtInt4) return (r & 3) << 1;
  if constexpr (FMT == kFmtInt8) return r & 6;
  return ((r >> 2) & 3) << 1;
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

// c += a b: m16n8k32, s8 operands, s32 accumulate (exact).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: m16n8k16, s8 operands (A reg0 row g, reg1 row g + 8, k-slots
// 4t4 .. 4t4 + 3; B k-slots 4t4 .. 4t4 + 3 of column g), s32 accumulate.
__device__ __forceinline__ void mma_s8_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// c += a b: m16n8k16 as mma_s8_k16, with A unsigned (u8) and B s8.
__device__ __forceinline__ void mma_u8s8_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// 16 x the low / high nibble of each byte of w, as int8 bytes.
__device__ __forceinline__ uint32_t lo16(uint32_t w) { return (w << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

// The low nibble times 16 of each byte of w, as int8 bytes: a per-byte
// int8 multiply by 16 (HOW 0, wrapping mod 256) or four doublings (HOW 1).
template <int HOW>
__device__ __forceinline__ uint32_t lo_times16(uint32_t w) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int8_t v = (int8_t)(w >> (8 * j));
    if constexpr (HOW == 0) {
      v = (int8_t)(v * 16);
    } else {
      v = (int8_t)(v + v);
      v = (int8_t)(v + v);
      v = (int8_t)(v + v);
      v = (int8_t)(v + v);
    }
    r |= (uint32_t)(uint8_t)v << (8 * j);
  }
  return r;
}

// qdot4_w4a8's activation rule for one value: clamp(rint(v / s), -127,
// 127), IEEE division, round half to even.
__device__ __forceinline__ int quant_s8(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

// The low bytes of a, b, c, d as one word (a lowest).
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// y [rows, out] = x [rows, in] @ W, W in format FMT:
//   int4  q packed [in/2, out], s4 [in/group, out]; group % (2 SROWS) == 0
//   int8  q [in, out], s [out]; x rows are xs apart (xs % 8 == 0, xs >= in,
//         x zero past in)
//   W4A8  x int8 [rows, in] (W4A8Q: bf16), q and s as int4; W4A8T: q
//         packed [out, in/2], s [out, in/group]; f32 sums of the group dots
//         times s / 16, times sx[r] when sx is given (W4A8Q: its own row
//         scales), stored as f32 (y_f32) or bf16
// Units: int4 and W4A8 groups, int8 ring stages of SROWS rows; each k-split
// takes `per` of them. y is bf16 but for W4A8 with y_f32.
// LO: the low-nibble unpack (W4A8 on q4; kLoShip otherwise). blk: W4A8R's
// groups a block (each split takes `per`, a multiple of it).
template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF,
          int LO = kLoShip>
__global__ void __launch_bounds__(WC * WK * 32)
    decode_rows_kernel(const void* __restrict__ xv, const uint8_t* __restrict__ q,
                       const float* __restrict__ s, void* __restrict__ yv,
                       const float* __restrict__ sx, int rows, long long in, long long out,
                       long long xs, int group, int per, int y_f32, int blk) {
  using L = DecodeSmem<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  constexpr bool I8 = L::int8, W8 = L::w4a8, TR = L::trans, QX = L::qx, BO = L::blocked;
  static_assert(LO == kLoShip || FMT == kFmtW4A8, "P2's unpacks: q4 only");
  constexpr int NT = RB / 8, GT = WC * 32, NTHR = WC * WK * 32, XE = L::x_elem;
  if constexpr ((PF & 16) != 0) return;
  extern __shared__ __align__(128) unsigned char dc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp % WC, wk = warp / WC, gtid = wc * 32 + lane;
  const int g = lane >> 2, t4 = lane & 3;
  const long long c0 = (long long)(blockIdx.x / csize) * L::cols;   // the strip's
  const long long nrows = I8 ? in : in / 2;   // weight rows (W4A8T: bytes of a row)
  const long long ng = I8 ? (in + SROWS - 1) / SROWS : in / group;  // units
  const long long g0 = min(ng, (long long)(rank * WK + wk) * per);
  const long long g1 = min(ng, g0 + per);
  const int spg = I8 ? 1 : group / (2 * SROWS);   // ring stages per unit
  const int n_st = (int)(g1 - g0) * spg;
  const long long p_first = g0 * (I8 ? SROWS : group / 2);   // the split's first row
  unsigned char* ring = dc_smem + wk * L::ring;
  const uint32_t ring_u = vstar::smem_u32(ring);
  const uint8_t* q_end = q + nrows * out;
  const unsigned char* xb = static_cast<const unsigned char*>(xv);
  bf16* y = static_cast<bf16*>(yv);
  // W4A8Q: the row scales it finds (after the receive slots)
  float* qsx = reinterpret_cast<float*>(dc_smem + WK * L::ring + L::col_scales + L::recv);
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
  // offset. W4A8T: chunk tq_c of the strip's rows tq_r0 + RPP it.
  constexpr int CPR = L::cols / 16, XJ = (RB * L::x_chunks + GT - 1) / GT;
  static_assert(GT % CPR == 0 && GT / CPR == 4, "a pass copies 4 rows");
  constexpr int SWP = W8 ? 4 : 2;   // passes after which the row swizzle repeats
  const int wq_c = gtid % CPR, wq_r0 = gtid / CPR;
  const bool wq_col = c0 + 16 * wq_c < out;
  const uint8_t* wq_src = q + (p_first + wq_r0) * out + c0 + 16 * wq_c;
  const long long wq_step = 4 * out, wq_stage = (long long)SROWS * out;
  const int wq_left = (int)min(nrows - p_first - wq_r0, (long long)INT_MAX);
  uint32_t wq_dst[SWP];   // by it % SWP
#pragma unroll
  for (int par = 0; par < SWP; ++par)
    wq_dst[par] = wq_r0 * L::w_row + (wq_c >> 3) * kDcCols +
                  (((wq_c & 7) ^ row_swizzle<FMT>(wq_r0 + 4 * par)) << 4);
  constexpr int CPT = SROWS / 16, RPP = GT / CPT;   // W4A8T: chunks a row, rows a pass
  const int tq_c = gtid % CPT, tq_r0 = gtid / CPT;
  const uint8_t* tq_src = q + (c0 + tq_r0) * nrows + p_first + 16 * tq_c;
  const uint32_t tq_dst = tq_r0 * SROWS + 16 * tq_c;
  const unsigned char* xq_src[XJ];
  uint32_t xq_dst[XJ];
  int xq_c8[XJ];
  bool xq_ok[XJ];
#pragma unroll
  for (int j = 0; j < XJ; ++j) {
    const int idx = gtid + GT * j, r = idx / L::x_chunks, c = idx % L::x_chunks;
    xq_ok[j] = r < rows;
    xq_src[j] = xb + (xq_ok[j] ? r : 0) * xs * XE + 16 * c;
    xq_dst[j] = r * L::x_row + ((c ^ (r & L::x_swz)) << 4);
    xq_c8[j] = 16 / XE * c;   // inputs before the chunk
  }

  auto load_weights = [&](int i, int slot) {
    const uint32_t dst = ring_u + slot * (uint32_t)L::stage;
    const long long p0 = p_first + (long long)i * SROWS;
    if constexpr ((PF & 8) != 0) {
    } else if constexpr (TR) {
      // SROWS bytes of each of the strip's rows, at row * SROWS
      const uint8_t* src = tq_src + (long long)i * SROWS;
#pragma unroll
      for (int it = 0; it < L::cols / RPP; ++it, src += RPP * nrows) {
        const bool ok = c0 + tq_r0 + it * RPP < out;
        cp_async16_pf<PF>(dst + tq_dst + it * RPP * SROWS, ok ? src : q, ok);
      }
    } else if constexpr (ALIGNED) {
      // rows of 128 * WC contiguous bytes; 16-byte chunk c of row r goes
      // to warp slice c / 8 at (c % 8) ^ row_swizzle(r)
      const uint8_t* src = wq_src + i * wq_stage;
#pragma unroll
      for (int it = 0; it < SROWS / 4; ++it, src += wq_step) {
        const bool ok = wq_col && (!I8 || i * SROWS + 4 * it < wq_left);
        cp_async16_pf<PF>(dst + wq_dst[it % SWP] + it * 4 * L::w_row, ok ? src : q, ok);
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
  };
  auto load_x = [&](int i, int slot) {
    // x rows [0, rows), the stage's inputs: chunk c of row r at c ^ (r %
    // 8) (fewer chunks: r modulo their count)
    const uint32_t xd = ring_u + slot * (uint32_t)L::stage + (uint32_t)L::w_bytes;
    const long long p0 = p_first + (long long)i * SROWS;
    const long long k0 = I8 ? p0 : 2 * p0;
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      if (!xq_ok[j]) continue;
      // through L1 (.ca): every k-split of every strip on the SM reads the
      // same x, which through L2 alone makes one hot line per stage
      if constexpr (I8) {   // zeros past the last input
        const bool ok = k0 + xq_c8[j] < xs;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(xd + xq_dst[j]), "l"(ok ? xq_src[j] + k0 * XE : xb),
                        "r"(ok ? 16 : 0));
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                     :: "r"(xd + xq_dst[j]), "l"(xq_src[j] + k0 * XE));
      }
    }
  };
  auto load_scales = [&](int i, int slot) {
    if constexpr (!I8) {
      if (i % spg == spg - 1) {   // the stage ends a group: its scales
        const long long gi = g0 + i / spg;
        const uint32_t sd =
            ring_u + slot * (uint32_t)L::stage + (uint32_t)(L::w_bytes + L::x_bytes);
        if constexpr (TR) {   // s [out, ng]: one per row of the strip
#pragma unroll
          for (int it = 0; it < L::cols / GT; ++it) {
            const int r = gtid + GT * it;
            const bool ok = c0 + r < out;
            vstar::cp_async4(sd + 4 * r, ok ? s + (c0 + r) * ng + gi : s, ok);
          }
        } else if constexpr (ALIGNED) {
          const float* src = s + gi * out + c0;
          const bool ok = c0 + 4 * gtid < out;
          vstar::cp_async16(sd + 16 * gtid, ok ? src + 4 * gtid : s, ok);
        } else {
          const float* src = s + gi * out + c0;
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
  if constexpr (W8 && !QX) {
    // the weights of the first stages before x: launched dependent on the
    // row quantization, this kernel waits here for it (a no-op otherwise)
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_st) {
        load_weights(st, st);
        load_scales(st, st);
      }
      vstar::cp_async_commit();
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st)
      if (st < n_st) load_x(st, st);
    vstar::cp_async_commit();
  } else {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_st) {
        load_weights(st, st);
        load_x(st, st);
        load_scales(st, st);
      }
      vstar::cp_async_commit();
    }
  }
  if constexpr (QX) {
    // each row's largest |x| over all its inputs (read whole, from global
    // memory), then sx = max(amax, 1e-8) / 127
    constexpr int NW = WC * WK;
    float* wmax = qsx + RB;   // [NW][RB]
    const bf16* xg = static_cast<const bf16*>(xv);
    float m[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      m[r] = 0.f;
      if (r < rows)
        for (long long k = 8 * threadIdx.x; k < in; k += 8 * NTHR) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(xg + r * xs + k));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            m[r] = fmaxf(m[r], fmaxf(fabsf(__uint_as_float(w[e] << 16)),
                                     fabsf(__uint_as_float(w[e] & 0xFFFF0000u))));
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
      if (lane == 0) wmax[warp * RB + r] = m[r];
    }
    __syncthreads();
    if (threadIdx.x < RB) {
      float a = 0.f;
      for (int w = 0; w < NW; ++w) a = fmaxf(a, wmax[w * RB + threadIdx.x]);
      qsx[threadIdx.x] = (int)threadIdx.x < rows ? __fdiv_rn(fmaxf(a, 1e-8f), 127.f) : 1.f;
    }
    __syncthreads();
  }
  // int4 sums each group in part and adds it, scaled, to acc; int8 sums
  // into acc directly; W4A8 sums each group's int32 dot in dsum (off: its
  // sums of x in xsum); W4A8R adds each block's acc to its total in part
  float acc[8][NT][4], part[8][NT][4];
  int dsum[8][NT][4], xsum[LO == kLoOff ? NT : 1][4];
  float (&sum)[8][NT][4] = I8 ? acc : part;
  float (&total)[8][NT][4] = BO ? part : acc;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = part[t][nt][e] = 0.f;

  uint32_t magic = 0;
  if constexpr (I8) magic = magic_2p23();
  for (int i = 0; i < n_st; ++i) {
    if constexpr (W8 && !QX) {   // x of the first stages came last
      if (i == 0)
        vstar::cp_async_wait<0>();
      else
        vstar::cp_async_wait<STAGES - 2>();
    } else {
      vstar::cp_async_wait<STAGES - 2>();
    }
    split_sync();
    if (i + STAGES - 1 < n_st) {
      load_weights(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      load_x(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      load_scales(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    }
    vstar::cp_async_commit();
    const unsigned char* sw = ring + (i % STAGES) * L::stage;
    const long long p0 = p_first + (long long)i * SROWS;
    if constexpr (W8) {
      if (i % spg == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dsum[t][nt][e] = 0;
              if constexpr (LO == kLoOff) xsum[nt][e] = 0;
            }
      }
    } else if constexpr (!I8) {
      if (i % spg == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[t][nt][e] = 0.f;
      }
    }
    if constexpr (W8) {
      constexpr int KPS = SROWS / 16;   // k-steps of 32 inputs a stage
      if constexpr ((PF & 4) == 0) {
        // B: row n's inputs off .. off + 7 of k-step ks, even ones in [0],
        // odd ones in [1]: the inputs of this thread's A words
        uint32_t bx[KPS][NT][2];
#pragma unroll
        for (int ks = 0; ks < KPS; ++ks)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = 8 * nt + g;
            const int off = TR ? 8 * (KPS * t4 + ks) : 32 * ks + 8 * t4;
            const unsigned char* xr = sw + L::w_bytes + n * L::x_row;
            const int sw_n = n & L::x_swz;
            if constexpr (QX) {
              const uint4 v =
                  *reinterpret_cast<const uint4*>(xr + (((off >> 3) ^ sw_n) << 4));
              const uint32_t w[4] = {v.x, v.y, v.z, v.w};
              const float sc = qsx[n];
              int qv[8];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                qv[2 * e] = quant_s8(__uint_as_float(w[e] << 16), sc);
                qv[2 * e + 1] = quant_s8(__uint_as_float(w[e] & 0xFFFF0000u), sc);
              }
              bx[ks][nt][0] = pack_s8(qv[0], qv[2], qv[4], qv[6]);
              bx[ks][nt][1] = pack_s8(qv[1], qv[3], qv[5], qv[7]);
            } else {
              const uint2 v = *reinterpret_cast<const uint2*>(
                  xr + (((off >> 4) ^ sw_n) << 4) + (off & 8));
              bx[ks][nt][0] = __byte_perm(v.x, v.y, 0x6420);
              bx[ks][nt][1] = __byte_perm(v.x, v.y, 0x7531);
            }
          }
        if constexpr (!TR) {
#pragma unroll
          for (int ks = 0; ks < KPS; ++ks) {
            uint32_t w[4][4];   // packed rows 16 ks + 4 t4 + i, columns 16g .. 16g + 15
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4) {
              const int r = 16 * ks + 4 * t4 + i4;
              row_bytes(sw, r, p0 + r, w[i4]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              // the 4 x 4 bytes (rows i4, columns 16g + 4j + e) transposed:
              // c[e] holds column e's four packed rows
              const uint32_t t0 = __byte_perm(w[0][j], w[1][j], 0x5140);
              const uint32_t t1 = __byte_perm(w[0][j], w[1][j], 0x7362);
              const uint32_t t2 = __byte_perm(w[2][j], w[3][j], 0x5140);
              const uint32_t t3 = __byte_perm(w[2][j], w[3][j], 0x7362);
              const uint32_t c[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                                     __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
              for (int h = 0; h < 2; ++h) {   // m-tile 2j + h: columns 4j + 2h, + 1
                const uint32_t ca = c[2 * h], cb = c[2 * h + 1];
                int (&d)[NT][4] = dsum[2 * j + h];
                if constexpr (LO == kLoShip || LO == kLoMul) {
                  const uint32_t a[4] = {LO == kLoShip ? lo16(ca) : lo_times16<0>(ca),
                                         LO == kLoShip ? lo16(cb) : lo_times16<0>(cb),
                                         hi16(ca), hi16(cb)};
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt) mma_s8(d[nt], a, bx[ks][nt][0], bx[ks][nt][1]);
                } else if constexpr (LO == kLoTwoAnd) {
                  const uint32_t a[4] = {(ca & 0x07070707u) << 4, (cb & 0x07070707u) << 4,
                                         hi16(ca), hi16(cb)};
                  const uint32_t m8a = (ca & 0x08080808u) << 4, m8b = (cb & 0x08080808u) << 4;
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt) {
                    mma_s8(d[nt], a, bx[ks][nt][0], bx[ks][nt][1]);
                    mma_s8_k16(d[nt], m8a, m8b, bx[ks][nt][0]);
                  }
                } else {
                  const uint32_t la = ((ca ^ 0x08080808u) & 0x0F0F0F0Fu) << 4;
                  const uint32_t lb = ((cb ^ 0x08080808u) & 0x0F0F0F0Fu) << 4;
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt) {
                    mma_u8s8_k16(d[nt], la, lb, bx[ks][nt][0]);
                    mma_s8_k16(d[nt], hi16(ca), hi16(cb), bx[ks][nt][1]);
                  }
                }
              }
            }
            if constexpr (LO == kLoOff) {   // the sums of xe: A = 1
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_s8_k16(xsum[nt], 0x01010101u, 0x01010101u, bx[ks][nt][0]);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            // M rows g and g + 8 of m-tile t: the warp's rows 16t + g and
            // 16t + 8 + g; words KPS t4 .. KPS t4 + KPS - 1 of each
            const unsigned char* ra = sw + (wc * kDcCols + 16 * t + g) * SROWS + 4 * KPS * t4;
            uint32_t wa[KPS], wb[KPS];
#pragma unroll
            for (int ks = 0; ks < KPS; ++ks) {
              wa[ks] = reinterpret_cast<const uint32_t*>(ra)[ks];
              wb[ks] = reinterpret_cast<const uint32_t*>(ra + 8 * SROWS)[ks];
            }
#pragma unroll
            for (int ks = 0; ks < KPS; ++ks) {
              const uint32_t a[4] = {lo16(wa[ks]), lo16(wb[ks]), hi16(wa[ks]), hi16(wb[ks])};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_s8(dsum[t][nt], a, bx[ks][nt][0], bx[ks][nt][1]);
            }
          }
        }
      }
      if (i % spg == spg - 1) {   // the group's dots, times its scales / 16
        const float* sc = reinterpret_cast<const float*>(sw + L::w_bytes + L::x_bytes);
        float sa[8], sb[8];   // of M rows g and g + 8 of each m-tile
        if constexpr (TR) {
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            sa[t] = sc[wc * kDcCols + 16 * t + g] * 0.0625f;
            sb[t] = sc[wc * kDcCols + 16 * t + 8 + g] * 0.0625f;
          }
        } else {
          const float4* s4v = reinterpret_cast<const float4*>(sc) + 32 * wc + 4 * g;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 v = s4v[j];
            sa[2 * j] = v.x * 0.0625f; sb[2 * j] = v.y * 0.0625f;
            sa[2 * j + 1] = v.z * 0.0625f; sb[2 * j + 1] = v.w * 0.0625f;
          }
        }
        if constexpr (LO == kLoOff) {   // less 8 * 16 sum(xe) of each row
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) dsum[t][nt][e] -= 128 * xsum[nt][e];
        }
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[t][nt][0] = fmaf((float)dsum[t][nt][0], sa[t], acc[t][nt][0]);
            acc[t][nt][1] = fmaf((float)dsum[t][nt][1], sa[t], acc[t][nt][1]);
            acc[t][nt][2] = fmaf((float)dsum[t][nt][2], sb[t], acc[t][nt][2]);
            acc[t][nt][3] = fmaf((float)dsum[t][nt][3], sb[t], acc[t][nt][3]);
          }
        if constexpr (BO) {
          if ((i / spg + 1) % blk == 0) {   // the block's end: its sum to the total
#pragma unroll
            for (int t = 0; t < 8; ++t)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  part[t][nt][e] += acc[t][nt][e];
                  acc[t][nt][e] = 0.f;
                }
          }
        }
      }
    } else {
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
      for (int e = 0; e < 4; ++e) {
        // the column of M row g (e < 2) or g + 8 of m-tile t
        const int col = TR ? 16 * t + g + 8 * (e >> 1) : 16 * g + 2 * t + (e >> 1);
        red[(8 * nt + 2 * t4 + (e & 1)) * kDcCols + col] = total[t][nt][e];
      }
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
      if constexpr (W8) {   // the activation scale, if any, and the type
        const float* rs = QX ? qsx : sx;
        if (rs != nullptr) total *= rs[r];
        if (y_f32)
          static_cast<float*>(yv)[r * out + c0 + col] = total;
        else
          y[r * out + c0 + col] = __float2bfloat16(total);
      } else {
        y[r * out + c0 + col] = __float2bfloat16(total);
      }
    }
  }
}

// Strips of 128 * WC columns, `cluster` blocks (WK splits each) per strip,
// one cluster per strip.
// W4A8: sx, y_f32 as for the kernel; pdl launches it dependent on the
// kernel before it on the stream (programmatic dependent launch).
// W4A8R: blk groups a block, a split takes whole blocks (1 otherwise).
template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF,
          int LO = kLoShip>
int launch_decode(const void* x, const uint8_t* q, const float* s, void* y, int rows,
                  long long in, long long out, long long xs, int group, int cluster,
                  cudaStream_t st, const float* sx = nullptr, int y_f32 = 0,
                  bool pdl = false, int blk = 1) {
  using L = DecodeSmem<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  constexpr auto kernel = decode_rows_kernel<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF, LO>;
  if (cluster < 1 || cluster > L::max_cluster || (!L::int8 && group % (2 * SROWS)) ||
      blk < 1 || (blk > 1 && !L::blocked) || (!L::int8 && (in / group) % blk))
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
  const int per = (int)(blk * ((units / blk + splits - 1) / splits));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(strips * cluster));
  cfg.blockDim = dim3(WC * WK * 32);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, q, s, y, sx, rows, in, out, xs, group, per, y_f32,
                           blk);
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

template <int FMT, int RB, bool ALIGNED, int SROWS, int STAGES, int WC, int WK, int PF,
          int LO = kLoShip>
int info_decode(long long* vals) {
  using L = DecodeSmem<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF>;
  return kernel_facts<decode_rows_kernel<FMT, RB, ALIGNED, SROWS, STAGES, WC, WK, PF, LO>>(
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

// run_decode for the W4A8 formats: x int8 (W4A8Q: bf16) with rows `in`
// apart, the row scales sx or nullptr, y f32 (y_f32) or bf16, and pdl as
// for launch_decode; LO and blk as for the kernel. W4A8T, W4A8R and the
// unpacks other than ship have aligned instantiations only.
template <int FMT, int SROWS, int STAGES, int WC, int WK, int PF, int LO = kLoShip>
int run_w4a8(bool info, int rows, bool aligned, long long* vals, const void* x,
             const uint8_t* q, const float* s, const float* sx, void* y, long long in,
             long long out, int group, int cluster, int y_f32, bool pdl, cudaStream_t st,
             int blk = 1) {
#define VSTAR_W4A8_CALL(RB, AL)                                                           \
  return info ? info_decode<FMT, RB, AL, SROWS, STAGES, WC, WK, PF, LO>(vals)             \
              : launch_decode<FMT, RB, AL, SROWS, STAGES, WC, WK, PF, LO>(                \
                    x, q, s, y, rows, in, out, in, group, cluster, st, sx, y_f32, pdl, blk)
  if constexpr (FMT == kFmtW4A8T || FMT == kFmtW4A8R || LO != kLoShip) {
    if (!aligned) return (int)cudaErrorInvalidValue;
    if (rows > 8) VSTAR_W4A8_CALL(16, true);
    VSTAR_W4A8_CALL(8, true);
  } else {
    if (rows > 8) {
      if (aligned) VSTAR_W4A8_CALL(16, true);
      VSTAR_W4A8_CALL(16, false);
    }
    if (aligned) VSTAR_W4A8_CALL(8, true);
    VSTAR_W4A8_CALL(8, false);
  }
#undef VSTAR_W4A8_CALL
}

}  // namespace
