// K3/K4 at other decode-row shapes than the shipped one, for
// kernel_probe.py --k3-shapes: each (ring rows per stage, stages, warps
// along the columns, k-splits per block, PF bits of decode_rows.cuh: L2
// prefetch and the timing breakdown) of the script's K3_VARIANTS, at a
// cluster size the caller gives. Built with
// kernel_probe.cu and int4_probe.cu into one library; includes the kernel
// library's int8_matvec.cu whole.
#include "../csrc/int8_matvec.cu"

namespace {

// The order of kernel_probe.py's K3_VARIANTS.
int dispatch_k3(int v, bool info_only, int rows, bool aligned, long long* vals,
                const bf16* x, const uint8_t* q, const float* s, bf16* y, long long in,
                long long out, long long xs, int cluster, cudaStream_t st) {
#define VSTAR_ARGS info_only, rows, aligned, vals, x, q, s, y, in, out, xs, 0, cluster, st
  switch (v) {
    case 0: return run_decode<VSTAR_K3_DECODE>(VSTAR_ARGS);          // shipped
    case 1: return run_decode<kFmtInt8, 32, 4, 1, 2, 0>(VSTAR_ARGS);
    case 2: return run_decode<kFmtInt8, 32, 3, 1, 4, 0>(VSTAR_ARGS);
    case 3: return run_decode<kFmtInt8, 32, 3, 1, 1, 0>(VSTAR_ARGS);
    case 4: return run_decode<kFmtInt8, 64, 3, 1, 2, 0>(VSTAR_ARGS);
    case 5: return run_decode<kFmtInt8, 32, 3, 2, 1, 0>(VSTAR_ARGS);
    case 6: return run_decode<kFmtInt8, 32, 3, 1, 2, 128>(VSTAR_ARGS);  // unpack, no mma
    case 7: return run_decode<kFmtInt8, 32, 3, 1, 2, 256>(VSTAR_ARGS);  // mma, no unpack
    case 8: return run_decode<kFmtInt8, 32, 3, 1, 2, 4>(VSTAR_ARGS);    // no products
    case 9: return run_decode<kFmtInt8, 32, 3, 1, 2, 8>(VSTAR_ARGS);    // no weight copies
    case 10: return run_decode<kFmtInt8, 32, 3, 1, 2, 16>(VSTAR_ARGS);  // nothing
    case 11: return run_decode<kFmtInt8, 32, 3, 1, 2, 32>(VSTAR_ARGS);  // no reduction
  }
#undef VSTAR_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Build facts of variant v (vstar_int8_kernel_info's six values).
extern "C" int probe_k3_info(int v, long long rows, long long aligned, long long* vals) {
  return dispatch_k3(v, true, (int)rows, aligned != 0, vals, nullptr, nullptr, nullptr,
                     nullptr, 0, 0, 0, 0, nullptr);
}

// vstar_int8_matvec's arguments, with the variant first.
extern "C" int probe_k3(int v, const void* x, const void* q, const void* s, void* y,
                        long long rows, long long in, long long out, long long xs,
                        long long cluster, long long aligned, void* stream) {
  return dispatch_k3(v, false, (int)rows, aligned != 0, nullptr, static_cast<const bf16*>(x),
                     static_cast<const uint8_t*>(q), static_cast<const float*>(s),
                     static_cast<bf16*>(y), in, out, xs, (int)cluster,
                     static_cast<cudaStream_t>(stream));
}
