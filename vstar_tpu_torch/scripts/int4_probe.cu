// K5's decode rows at other ring shapes than the shipped one, for
// kernel_probe.py --k5-shapes: each (packed rows per stage, stages, warps
// along the columns, k-splits per block, L2 prefetch size) of the script's
// K5_VARIANTS, at a cluster size the caller
// gives.
// Built with kernel_probe.cu into one library; includes the kernel
// library's int4_matmul.cu whole.
#include "../csrc/int4_matmul.cu"

namespace {

template <int SROWS, int STAGES, int WC, int WK, int PF>
int run_k5(bool info_only, int rows, bool aligned, long long* vals, const bf16* x,
           const uint8_t* q4, const float* s4, bf16* y, long long in, long long out,
           int group, int cluster, cudaStream_t st) {
  if (info_only) {
    if (rows > 8)
      return aligned ? info_k5<16, true, SROWS, STAGES, WC, WK, PF>(vals)
                     : info_k5<16, false, SROWS, STAGES, WC, WK, PF>(vals);
    return aligned ? info_k5<8, true, SROWS, STAGES, WC, WK, PF>(vals)
                   : info_k5<8, false, SROWS, STAGES, WC, WK, PF>(vals);
  }
  if (rows > 8)
    return aligned ? launch_k5_decode<16, true, SROWS, STAGES, WC, WK, PF>(
                         x, q4, s4, y, rows, in, out, group, cluster, st)
                   : launch_k5_decode<16, false, SROWS, STAGES, WC, WK, PF>(
                         x, q4, s4, y, rows, in, out, group, cluster, st);
  return aligned ? launch_k5_decode<8, true, SROWS, STAGES, WC, WK, PF>(
                       x, q4, s4, y, rows, in, out, group, cluster, st)
                 : launch_k5_decode<8, false, SROWS, STAGES, WC, WK, PF>(
                       x, q4, s4, y, rows, in, out, group, cluster, st);
}

// The order of kernel_probe.py's K5_VARIANTS.
int dispatch_k5(int v, bool info_only, int rows, bool aligned, long long* vals,
                const bf16* x, const uint8_t* q4, const float* s4, bf16* y, long long in,
                long long out, int group, int cluster, cudaStream_t st) {
#define VSTAR_ARGS info_only, rows, aligned, vals, x, q4, s4, y, in, out, group, cluster, st
  switch (v) {
    case 0: return run_k5<VSTAR_K5_DECODE>(VSTAR_ARGS);   // shipped
    case 1: return run_k5<32, 4, 1, 4, 0>(VSTAR_ARGS);
    case 2: return run_k5<32, 3, 2, 2, 0>(VSTAR_ARGS);
    case 3: return run_k5<16, 6, 1, 4, 0>(VSTAR_ARGS);
    case 4: return run_k5<32, 3, 1, 4, 2>(VSTAR_ARGS);
    case 5: return run_k5<32, 3, 1, 4, 4>(VSTAR_ARGS);    // no products
    case 6: return run_k5<32, 3, 1, 4, 8>(VSTAR_ARGS);    // no weight copies
    case 7: return run_k5<32, 3, 1, 4, 12>(VSTAR_ARGS);   // neither
    case 8: return run_k5<32, 3, 1, 4, 44>(VSTAR_ARGS);   // nor the reduction
    case 9: return run_k5<32, 3, 1, 4, 16>(VSTAR_ARGS);   // nothing
  }
#undef VSTAR_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Build facts of variant v (vstar_int4_kernel_info's six values).
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
