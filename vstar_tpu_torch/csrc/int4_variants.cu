// P1-P4: the kernels of the int4 profile (vstar_tpu_torch/scripts/
// int4_profile.py) on sm_90a.
//
// They replace the Pallas kernels of scripts/int4_profile.py, the JAX
// package's experiment on the W4A8 (K6) design. Weight format as K6's
// (nn/quant.quantize_weight_int4): q4 uint8 [IN/2, OUT], packed row p holds
// input 2p in its low nibble and 2p+1 in its high nibble, both
// two's-complement signed; s4 f32 [NG, OUT].
//
// P1 (probe_mosaic, k_mul / k_add): u8 q -> int8 (q & 0xF) << 4, the lo
//   nibble times 16, as one per-byte int8 multiply by 16 (HOW 0) or as four
//   doublings (HOW 1). Elementwise, bound by the bytes.
// P2 (_w4a8_call with _w4a8_kernel_mul / _2and / _off and the shipping
//   _w4a8_kernel): K6's function, f32 y[R, OUT] = per group the exact int32
//   dot of xq with 16 * nibble, times s4 / 16, with a given lo-nibble unpack
//   (ship, mul, 2and, off): K6's decode rows (decode_rows.cuh, format W4A8)
//   with the unpack as a template dimension (LO) and block_o / 128 warps
//   side by side, so that a block's strip is the TPU's block_o columns;
//   ship at 256 columns is K6's own instantiation. 2and and off fold the
//   16 x into their low bytes (2and's masks times 16 fit int8; off's
//   16 (lo + 8) is a uint8 A operand), so every unpack sums in K6's one
//   accumulator; off's 8 * sum(xe) comes from one mma a k-step on the B
//   fragments the ring already holds.
// P3 (_w4a8_call_rows): K6's function summed in blocks of block_i packed
//   rows, the blocks' sums added in block order, as the TPU's `o_ref +=
//   acc`: the decode rows in their W4A8R format at K6's shape and plan,
//   each k-split a run of whole blocks whose sums it adds to its total in
//   order, the cluster adding the splits in rank order. (The TPU kernel's
//   point was whole-row reads: 512- and 1024-column strips measured slower
//   than K6's 256 on the H100.)
// P4 (_w4a8_call_t): K6's function on transposed storage, q4t u8 [OUT, IN/2]
//   and s4t f32 [OUT, NG]: K6's decode rows in their W4A8T format
//   (decode_rows.cuh). A word of one output's row is four packed inputs,
//   so the two masks give two m16n8k32 A registers with no byte permute;
//   a ring stage holds 32 packed bytes of each of a strip's 128 rows, and
//   the scales of a group are gathered one per row. block_o (the TPU's
//   grid) selects nothing here: every strip is 128 rows.
//
// P2-P4 are one launch with no workspace: every group dot is exact in
// int32 and scaled as d * (s4 / 16); the k-splits are added across a
// thread-block cluster in rank order (deterministic, no atomics). Domain:
// R <= 16, OUT % block_o == 0 (P2), OUT % 16 == 0 (P3), a group of a
// multiple of 128 inputs, IN % 32 == 0, 16-byte aligned operands.
#include "decode_rows.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

template <int HOW>
__global__ void __launch_bounds__(kThreads)
    unpack_probe_kernel(const uint8_t* __restrict__ q, int8_t* __restrict__ o,
                        long long n, int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 16;
    for (long long i = tid; i < nv; i += stride) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + i);
      v.x = lo_times16<HOW>(v.x);
      v.y = lo_times16<HOW>(v.y);
      v.z = lo_times16<HOW>(v.z);
      v.w = lo_times16<HOW>(v.w);
      reinterpret_cast<uint4*>(o)[i] = v;
    }
    done = nv * 16;
  }
  for (long long i = done + tid; i < n; i += stride)
    o[i] = (int8_t)(lo_times16<HOW>(q[i]) & 0xFFu);
}

// ---------------------------------------------------------------------------
// P2-P4: shapes of the decode rows
// ---------------------------------------------------------------------------

// P2's decode-row shape: K6's (VSTAR_K6_DECODE, int4_matmul.cu: 64 packed
// rows a stage, 3 stages, one k-split a block) with WC = block_o / 128
// warps side by side, so that a block's strip is block_o columns, and the
// low-nibble unpack LO.
#define VSTAR_P2_DECODE(WC, LO) kFmtW4A8, 64, 3, WC, 1, 0, LO
// P3's: K6's shape (256-column strips), one k-split of whole row blocks a
// block. It beat 512- and 1024-column strips, deeper rings and two k-splits
// a block in kernel_probe.py --p23-shapes (PERF.md).
#define VSTAR_P3_DECODE kFmtW4A8R, 64, 3, 2, 1, 0
// P4's: 64 packed bytes (one group) of each row a stage, 3 stages, one
// warp per 128-row strip, two k-splits a block (kernel_probe.py
// --k6-shapes; PERF.md).
#define VSTAR_P4_DECODE kFmtW4A8T, 64, 3, 1, 2, 0

// P2 at `unpack` (0 ship, 1 mul, 2 2and, 3 off) and `cols` (256 / 512):
// launches it, or with info set reports its build facts into vals.
int run_p2(int unpack, int cols, bool info, int rows, long long* vals, const void* xq,
           const uint8_t* q4, const float* s4, void* y, long long in, long long out,
           int group, int cluster, cudaStream_t st) {
#define VSTAR_P2_RUN(WC, LO)                                                                 \
  return run_w4a8<VSTAR_P2_DECODE(WC, LO)>(info, rows, true, vals, xq, q4, s4, nullptr, y, in, \
                                           out, group, cluster, 1, false, st)
#define VSTAR_P2_COLS(LO)              \
  if (cols == 512) VSTAR_P2_RUN(4, LO); \
  VSTAR_P2_RUN(2, LO)
  switch (unpack) {
    case kLoShip: VSTAR_P2_COLS(kLoShip);
    case kLoMul: VSTAR_P2_COLS(kLoMul);
    case kLoTwoAnd: VSTAR_P2_COLS(kLoTwoAnd);
    default: VSTAR_P2_COLS(kLoOff);
  }
#undef VSTAR_P2_COLS
#undef VSTAR_P2_RUN
}

// Shared argument checks of P2-P4 on the decode rows: rows 1..16, a group
// of a multiple of 128 inputs (a whole number of ring stages) dividing in,
// in % 32 == 0.
bool bad_args(long long rows, long long in, long long out, long long group) {
  return rows < 1 || rows > vstar::kMaxRows || group < 128 || group % 128 || in % group ||
         in % 32 || out < 1;
}

}  // namespace

// P1: o [n] int8 = (q [n] & 0xF) << 4, by a per-byte multiply (how 0) or
// four doublings (how 1). 16-byte vectors where both pointers allow it.
extern "C" int vstar_unpack_probe(const void* q, void* o, long long n, long long how,
                                  void* stream) {
  if (n < 1 || how < 0 || how > 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int vec = (reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(o) % 16 == 0);
  const long long units = vec ? (n + 15) / 16 : n;
  const long long want = (units + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  auto* qb = static_cast<const uint8_t*>(q);
  auto* ob = static_cast<int8_t*>(o);
  if (how == 0)
    unpack_probe_kernel<0><<<blocks, kThreads, 0, st>>>(qb, ob, n, vec);
  else
    unpack_probe_kernel<1><<<blocks, kThreads, 0, st>>>(qb, ob, n, vec);
  return (int)cudaGetLastError();
}

// Blocks of P2's kernel (`unpack` 0-3, `cols` 256 / 512) for `rows`
// (<= 16) that one SM holds, into *blocks.
extern "C" int vstar_w4a8_variant_occupancy(long long unpack, long long rows, long long cols,
                                            void* blocks) {
  long long vals[6];
  const int err = run_p2((int)unpack, (int)cols, true, (int)rows, vals, nullptr, nullptr,
                         nullptr, nullptr, 0, 0, 0, 0, nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Blocks of P3's kernel for `rows` (<= 16) that one SM holds, into *blocks.
extern "C" int vstar_w4a8_rows_occupancy(long long rows, void* blocks) {
  long long vals[6];
  const int err = run_w4a8<VSTAR_P3_DECODE>(true, (int)rows, true, vals, nullptr, nullptr,
                                            nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, false,
                                            nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Build facts of P2's and P3's i-th instantiation (P2: unpack i / 4, 256
// or 512 columns, rows 8 / 16; then P3 at rows 8 / 16); -1 past the last.
extern "C" int vstar_w4a8_variants_kernel_info(int i, const char** name, long long* vals) {
  static const char* names[] = {
      "w4a8_variant<ship, 256, 8>", "w4a8_variant<ship, 256, 16>",
      "w4a8_variant<ship, 512, 8>", "w4a8_variant<ship, 512, 16>",
      "w4a8_variant<mul, 256, 8>",  "w4a8_variant<mul, 256, 16>",
      "w4a8_variant<mul, 512, 8>",  "w4a8_variant<mul, 512, 16>",
      "w4a8_variant<2and, 256, 8>", "w4a8_variant<2and, 256, 16>",
      "w4a8_variant<2and, 512, 8>", "w4a8_variant<2and, 512, 16>",
      "w4a8_variant<off, 256, 8>",  "w4a8_variant<off, 256, 16>",
      "w4a8_variant<off, 512, 8>",  "w4a8_variant<off, 512, 16>",
      "w4a8_rows<8>",               "w4a8_rows<16>"};
  if (i < 0 || i > 17) return -1;
  *name = names[i];
  const int rows = i % 2 ? 16 : 8;
  if (i >= 16)
    return run_w4a8<VSTAR_P3_DECODE>(true, rows, true, vals, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, 0, 0, 0, 0, 1, false, nullptr);
  return run_p2(i / 4, i % 4 < 2 ? 256 : 512, true, rows, vals, nullptr, nullptr, nullptr,
                nullptr, 0, 0, 0, 0, nullptr);
}

// P2: y [rows, out] f32 = xq [rows, in] int8 @ nib(q4 [in/2, out]) with
// each group's int32 dot times s4 [in/group, out] / 16; `unpack` 0 ship, 1
// mul, 2 2and, 3 off; `cols` (block_o) 256 or 512 dividing out: the
// columns of a block's strip; `cluster` (1..16) blocks per strip. Contiguous
// operands, 16-byte aligned; bad_args' domain.
extern "C" int vstar_w4a8_variant(const void* xq, const void* q4, const void* s4, void* y,
                                  long long rows, long long in, long long out, long long group,
                                  long long unpack, long long cols, long long cluster,
                                  void* stream) {
  if (bad_args(rows, in, out, group) || unpack < 0 || unpack > 3 ||
      (cols != 256 && cols != 512) || out % cols)
    return (int)cudaErrorInvalidValue;
  return run_p2((int)unpack, (int)cols, false, (int)rows, nullptr, xq,
                static_cast<const uint8_t*>(q4), static_cast<const float*>(s4), y, in, out,
                (int)group, (int)cluster, static_cast<cudaStream_t>(stream));
}

// P3: P2's function (ship) with its sums in blocks of block_i packed rows
// (a multiple of group / 2 dividing in / 2), added in block order: a
// k-split takes whole blocks, the cluster (`cluster` blocks a 256-column
// strip) adds the splits in rank order. out % 16 == 0, contiguous operands,
// 16-byte aligned; bad_args' domain.
extern "C" int vstar_w4a8_rows(const void* xq, const void* q4, const void* s4, void* y,
                               long long rows, long long in, long long out, long long group,
                               long long block_i, long long cluster, void* stream) {
  if (bad_args(rows, in, out, group) || out % 16 || block_i < 1 || block_i % (group / 2) ||
      (in / 2) % block_i)
    return (int)cudaErrorInvalidValue;
  return run_w4a8<VSTAR_P3_DECODE>(false, (int)rows, true, nullptr, xq,
                                   static_cast<const uint8_t*>(q4),
                                   static_cast<const float*>(s4), nullptr, y, in, out,
                                   (int)group, (int)cluster, 1, false,
                                   static_cast<cudaStream_t>(stream),
                                   (int)(block_i / (group / 2)));
}

// Blocks of P4's kernel for `rows` (<= 16) that one SM holds, into *blocks.
extern "C" int vstar_w4a8_t_occupancy(long long rows, void* blocks) {
  long long vals[6];
  const int err = run_w4a8<VSTAR_P4_DECODE>(true, (int)rows, true, vals, nullptr, nullptr,
                                            nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, false,
                                            nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Build facts of P4's i-th instantiation (rows 8 / 16); -1 past the last.
extern "C" int vstar_w4a8_t_kernel_info(int i, const char** name, long long* vals) {
  static const char* names[] = {"w4a8t_decode<8>", "w4a8t_decode<16>"};
  if (i < 0 || i > 1) return -1;
  *name = names[i];
  return run_w4a8<VSTAR_P4_DECODE>(true, i ? 16 : 8, true, vals, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, 0, 0, 0, 0, 1, false, nullptr);
}

// P4: y [rows, out] f32 = P2's function on transposed storage q4t [out,
// in/2], s4t [out, in/group]; group % 128 == 0, in % 32 == 0, q4t 16-byte
// aligned, contiguous operands, xq 16-byte aligned; `cluster` (1..16)
// blocks per strip of 128 output rows.
extern "C" int vstar_w4a8_t(const void* xq, const void* q4t, const void* s4t, void* y,
                            long long rows, long long in, long long out, long long group,
                            long long cluster, void* stream) {
  if (bad_args(rows, in, out, group)) return (int)cudaErrorInvalidValue;
  return run_w4a8<VSTAR_P4_DECODE>(false, (int)rows, true, nullptr, xq,
                                   static_cast<const uint8_t*>(q4t),
                                   static_cast<const float*>(s4t), nullptr, y, in, out,
                                   (int)group, (int)cluster, 1, false,
                                   static_cast<cudaStream_t>(stream));
}
