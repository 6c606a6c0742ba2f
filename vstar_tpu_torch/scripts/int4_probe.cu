// K5 at other shapes than the shipped ones, for kernel_probe.py:
//   --k5-shapes  the decode rows at other ring shapes: each (packed rows
//                per stage, stages, warps along the columns, k-splits per
//                block, L2 prefetch size) of the script's K5_VARIANTS, at
//                a cluster size the caller gives;
//   --k5-tiles   the tiles (R > 16) at each (BM, BN, stages, k-splits, PF
//                bits of int4_tile_kernel) of the script's
//                K5_TILE_VARIANTS (aligned operands only);
//   --k6-shapes  K6's and P4's decode rows (W4A8, W4A8T) at each (format,
//                packed rows per stage, stages, warps along the columns,
//                k-splits per block, PF bits) of the script's K6_VARIANTS;
//   --w4a8-quant K6 quantizing its bf16 rows itself (kFmtW4A8Q), against
//                the shipped row quantization launch + K6;
//   --p23-shapes P3's decode rows (W4A8R) and P2's at 512 columns at each
//                (format, packed rows per stage, stages, warps along the
//                columns, k-splits per block, PF bits, unpack) of the
//                script's P23_VARIANTS.
// Built with kernel_probe.cu and k3_probe.cu into one library; includes
// the kernel library's int4_matmul.cu whole.
#include "../csrc/int4_matmul.cu"

namespace {

// The order of kernel_probe.py's K5_VARIANTS.
int dispatch_k5(int v, bool info_only, int rows, bool aligned, long long* vals,
                const bf16* x, const uint8_t* q4, const float* s4, bf16* y, long long in,
                long long out, int group, int cluster, cudaStream_t st) {
#define VSTAR_ARGS info_only, rows, aligned, vals, x, q4, s4, y, in, out, in, group, cluster, st
  switch (v) {
    case 0: return run_decode<VSTAR_K5_DECODE>(VSTAR_ARGS);          // shipped
    case 1: return run_decode<kFmtInt4, 32, 4, 1, 4, 0>(VSTAR_ARGS);
    case 2: return run_decode<kFmtInt4, 32, 3, 2, 2, 0>(VSTAR_ARGS);
    case 3: return run_decode<kFmtInt4, 16, 6, 1, 4, 0>(VSTAR_ARGS);
    case 4: return run_decode<kFmtInt4, 32, 3, 1, 4, 2>(VSTAR_ARGS);
    case 5: return run_decode<kFmtInt4, 32, 3, 1, 4, 4>(VSTAR_ARGS);    // no products
    case 6: return run_decode<kFmtInt4, 32, 3, 1, 4, 8>(VSTAR_ARGS);    // no weight copies
    case 7: return run_decode<kFmtInt4, 32, 3, 1, 4, 12>(VSTAR_ARGS);   // neither
    case 8: return run_decode<kFmtInt4, 32, 3, 1, 4, 44>(VSTAR_ARGS);   // nor the reduction
    case 9: return run_decode<kFmtInt4, 32, 3, 1, 4, 16>(VSTAR_ARGS);   // nothing
  }
#undef VSTAR_ARGS
  return (int)cudaErrorInvalidValue;
}

// The order of kernel_probe.py's K5_TILE_VARIANTS: (BM, BN, stages, KS).
int dispatch_tile(int v, long long* vals, const bf16* x, const uint8_t* q4, const float* s4,
                  bf16* y, int rows, long long in, long long out, int group, cudaStream_t st) {
#define VSTAR_TV(BM, BN, S, KS, PF)                                                       \
  return vals ? info_k5_tiles<BM, BN, S, true, KS, PF>(vals)                              \
              : launch_k5_tiles<BM, BN, S, true, KS, PF>(x, q4, s4, y, rows, in, out, group, st)
  switch (v) {
    case 0: VSTAR_TV(64, 128, 3, 1, 0);
    case 1: VSTAR_TV(128, 256, 3, 1, 0);
    case 2: VSTAR_TV(128, 128, 3, 1, 0);
    case 3: VSTAR_TV(64, 128, 3, 2, 0);
    case 4: VSTAR_TV(64, 128, 3, 4, 0);
    case 5: VSTAR_TV(128, 256, 3, 2, 0);
    case 6: VSTAR_TV(128, 256, 3, 4, 0);
    case 7: VSTAR_TV(128, 256, 4, 1, 0);
    case 8: VSTAR_TV(128, 256, 3, 1, 2);   // no dequantization
    case 9: VSTAR_TV(128, 256, 3, 1, 4);   // no products
    case 10: VSTAR_TV(128, 256, 3, 1, 8);  // no global copies
    case 11: VSTAR_TV(128, 256, 3, 1, 6);  // copies only
  }
#undef VSTAR_TV
  return (int)cudaErrorInvalidValue;
}

// P4's shipped shape (int4_variants.cu VSTAR_P4_DECODE, which this
// library does not include).
#define VSTAR_P4_SHAPE kFmtW4A8T, 64, 3, 1, 2, 0

// The order of kernel_probe.py's K6_VARIANTS: (format, packed rows per
// stage, stages, warps along the columns, k-splits per block, PF).
int dispatch_k6(int v, bool info_only, int rows, bool aligned, long long* vals, const void* x,
                const uint8_t* q4, const float* s4, const float* sx, void* y, long long in,
                long long out, int group, int cluster, int y_f32, bool pdl, cudaStream_t st) {
#define VSTAR_ARGS \
  info_only, rows, aligned, vals, x, q4, s4, sx, y, in, out, group, cluster, y_f32, pdl, st
  switch (v) {
    case 0: return run_w4a8<VSTAR_K6_DECODE>(VSTAR_ARGS);              // shipped
    case 1: return run_w4a8<kFmtW4A8Q, 64, 3, 2, 1, 0>(VSTAR_ARGS);   // rows quantized inside
    case 2: return run_w4a8<kFmtW4A8, 32, 3, 1, 4, 0>(VSTAR_ARGS);    // K5's shape
    case 3: return run_w4a8<kFmtW4A8, 32, 4, 1, 4, 0>(VSTAR_ARGS);
    case 4: return run_w4a8<kFmtW4A8, 32, 3, 1, 2, 0>(VSTAR_ARGS);
    case 5: return run_w4a8<kFmtW4A8, 64, 3, 1, 2, 0>(VSTAR_ARGS);
    case 6: return run_w4a8<kFmtW4A8, 32, 3, 2, 2, 0>(VSTAR_ARGS);
    case 7: return run_w4a8<kFmtW4A8, 64, 4, 1, 2, 0>(VSTAR_ARGS);
    case 8: return run_w4a8<kFmtW4A8, 64, 3, 1, 4, 0>(VSTAR_ARGS);
    case 9: return run_w4a8<kFmtW4A8, 64, 4, 1, 1, 0>(VSTAR_ARGS);
    case 10: return run_w4a8<kFmtW4A8, 64, 3, 2, 1, 4>(VSTAR_ARGS);   // no products
    case 11: return run_w4a8<kFmtW4A8, 64, 3, 2, 1, 8>(VSTAR_ARGS);   // no weight copies
    case 12: return run_w4a8<kFmtW4A8, 64, 3, 2, 1, 16>(VSTAR_ARGS);  // nothing
    case 13: return run_w4a8<VSTAR_P4_SHAPE>(VSTAR_ARGS);              // P4 shipped
    case 14: return run_w4a8<kFmtW4A8T, 32, 3, 1, 4, 0>(VSTAR_ARGS);
    case 15: return run_w4a8<kFmtW4A8T, 32, 4, 1, 4, 0>(VSTAR_ARGS);
    case 16: return run_w4a8<kFmtW4A8T, 64, 4, 1, 2, 0>(VSTAR_ARGS);
    case 17: return run_w4a8<kFmtW4A8T, 64, 3, 1, 4, 0>(VSTAR_ARGS);
    case 18: return run_w4a8<kFmtW4A8T, 64, 3, 2, 1, 0>(VSTAR_ARGS);  // K6's shape
    case 19: return run_w4a8<kFmtW4A8T, 64, 3, 1, 2, 4>(VSTAR_ARGS);  // no products
  }
#undef VSTAR_ARGS
  return (int)cudaErrorInvalidValue;
}

// The order of kernel_probe.py's P23_VARIANTS: (format, packed rows per
// stage, stages, warps along the columns, k-splits per block, PF).
int dispatch_p23(int v, bool info_only, int rows, long long* vals, const void* x,
                 const uint8_t* q4, const float* s4, void* y, long long in, long long out,
                 int group, int cluster, int blk, cudaStream_t st) {
#define VSTAR_ARGS \
  info_only, rows, true, vals, x, q4, s4, nullptr, y, in, out, group, cluster, 1, false, st, blk
  switch (v) {
    // P3 shipped (int4_variants.cu VSTAR_P3_DECODE: K6's shape)
    case 0: return run_w4a8<kFmtW4A8R, 64, 3, 2, 1, 0>(VSTAR_ARGS);
    case 1: return run_w4a8<kFmtW4A8R, 32, 3, 4, 1, 0>(VSTAR_ARGS);   // 512 columns
    case 2: return run_w4a8<kFmtW4A8R, 32, 3, 8, 1, 0>(VSTAR_ARGS);   // 1024 columns
    case 3: return run_w4a8<kFmtW4A8R, 64, 4, 2, 1, 0>(VSTAR_ARGS);   // a deeper ring
    case 4: return run_w4a8<kFmtW4A8R, 64, 3, 2, 1, 4>(VSTAR_ARGS);   // no products
    case 5: return run_w4a8<kFmtW4A8R, 64, 3, 2, 1, 8>(VSTAR_ARGS);   // no weight copies
    case 6: return run_w4a8<kFmtW4A8R, 64, 3, 2, 1, 12>(VSTAR_ARGS);  // neither
    case 7: return run_w4a8<kFmtW4A8R, 64, 3, 2, 1, 16>(VSTAR_ARGS);  // nothing
    case 8: return run_w4a8<kFmtW4A8, 64, 3, 4, 1, 0>(VSTAR_ARGS);    // P2 at 512 shipped
    case 9: return run_w4a8<kFmtW4A8, 32, 3, 4, 1, 0>(VSTAR_ARGS);
    case 10: return run_w4a8<kFmtW4A8, 64, 3, 4, 1, 4>(VSTAR_ARGS);   // no products
    case 11: return run_w4a8<kFmtW4A8, 64, 3, 4, 1, 8>(VSTAR_ARGS);   // no weight copies
    case 12: return run_w4a8<kFmtW4A8, 64, 3, 4, 1, 16>(VSTAR_ARGS);  // nothing
  }
#undef VSTAR_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Build facts of P23 variant v at `rows` (vstar_int4_kernel_info's six
// values).
extern "C" int probe_p23_info(int v, long long rows, long long* vals) {
  return dispatch_p23(v, true, (int)rows, vals, nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
                      0, 1, nullptr);
}

// P23 variant v: vstar_w4a8_rows' arguments with blk (groups a block; 1
// for the W4A8 variants) for block_i; aligned operands, group % 128 == 0.
extern "C" int probe_p23(int v, const void* x, const void* q4, const void* s4, void* y,
                         long long rows, long long in, long long out, long long group,
                         long long blk, long long cluster, void* stream) {
  if (rows < 1 || rows > 16 || group % 128 || in % group || blk < 1 || (in / group) % blk)
    return (int)cudaErrorInvalidValue;
  return dispatch_p23(v, false, (int)rows, nullptr, x, static_cast<const uint8_t*>(q4),
                      static_cast<const float*>(s4), y, in, out, (int)group, (int)cluster,
                      (int)blk, static_cast<cudaStream_t>(stream));
}

// Build facts of K6 variant v (vstar_int4_kernel_info's six values).
extern "C" int probe_k6_info(int v, long long rows, long long aligned, long long* vals) {
  return dispatch_k6(v, true, (int)rows, aligned != 0, vals, nullptr, nullptr, nullptr,
                     nullptr, nullptr, 0, 0, 0, 0, 0, false, nullptr);
}

// vstar_int4_w4a8's arguments (x int8; bf16 for the W4A8Q variant; q4t
// and s4t for the W4A8T ones), with the variant first.
extern "C" int probe_k6(int v, const void* x, const void* q4, const void* s4, const void* sx,
                        void* y, long long rows, long long in, long long out, long long group,
                        long long cluster, long long aligned, long long y_f32, long long pdl,
                        void* stream) {
  if (rows < 1 || rows > 16 || group % 64 || in % group) return (int)cudaErrorInvalidValue;
  return dispatch_k6(v, false, (int)rows, aligned != 0, nullptr, x,
                     static_cast<const uint8_t*>(q4), static_cast<const float*>(s4),
                     static_cast<const float*>(sx), y, in, out, (int)group, (int)cluster,
                     (int)y_f32, pdl != 0, static_cast<cudaStream_t>(stream));
}

// Build facts of decode-row variant v (vstar_int4_kernel_info's six values).
extern "C" int probe_k5_info(int v, long long rows, long long aligned, long long* vals) {
  return dispatch_k5(v, true, (int)rows, aligned != 0, vals, nullptr, nullptr, nullptr,
                     nullptr, 0, 0, 0, 0, nullptr);
}

// vstar_int4_matmul's decode-row arguments, with the variant first.
extern "C" int probe_k5(int v, const void* x, const void* q4, const void* s4, void* y,
                        long long rows, long long in, long long out, long long group,
                        long long cluster, long long aligned, void* stream) {
  return dispatch_k5(v, false, (int)rows, aligned != 0, nullptr,
                     static_cast<const bf16*>(x), static_cast<const uint8_t*>(q4),
                     static_cast<const float*>(s4), static_cast<bf16*>(y), in, out,
                     (int)group, (int)cluster, static_cast<cudaStream_t>(stream));
}

// Build facts of tile variant v.
extern "C" int probe_tile_info(int v, long long* vals) {
  return dispatch_tile(v, vals, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, nullptr);
}

// Tile variant v on aligned operands (rows > 16, group % 64 == 0).
extern "C" int probe_tile(int v, const void* x, const void* q4, const void* s4, void* y,
                          long long rows, long long in, long long out, long long group,
                          void* stream) {
  return dispatch_tile(v, nullptr, static_cast<const bf16*>(x),
                       static_cast<const uint8_t*>(q4), static_cast<const float*>(s4),
                       static_cast<bf16*>(y), (int)rows, in, out, (int)group,
                       static_cast<cudaStream_t>(stream));
}
