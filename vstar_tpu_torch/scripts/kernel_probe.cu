// K7's two kernels at other tiles than the shipped ones, for
// kernel_probe.py --k7-tiles: each (query rows, key tile, stages) of the
// dQ kernel and (keys, query tile, stages) of the dK/dV kernel in the
// script's DQ_VARIANTS / DKV_VARIANTS order. Built apart from the kernel
// library, which it includes whole (BwdParams, the kernels and their
// launchers come from there).
#include "../csrc/flash_attention_bwd.cu"
// vstar_graph_kernel_nodes, which --ab reads for the launches of a call in
// any checkout (--root)
#include "../csrc/graph_info.cu"

namespace {

// Launches variant v of kernel `which` (0: dQ, 1: dK/dV), or with info
// != nullptr reports its build facts (run_dq's six values) instead.
int dispatch(int which, int v, const BwdParams& p, cudaStream_t s, long long* info) {
  if (which == 0) {
    switch (v) {
      case 0: return run_dq<VSTAR_DQ_TILE>(p, s, info);   // shipped
      case 1: return run_dq<64, 32, 2>(p, s, info);
      case 2: return run_dq<64, 32, 3>(p, s, info);
      case 3: return run_dq<64, 64, 3>(p, s, info);
    }
  } else {
    switch (v) {
      case 0: return run_dkv<VSTAR_DKV_TILE>(p, s, info);  // shipped
      case 1: return run_dkv<64, 32, 2>(p, s, info);
      case 2: return run_dkv<64, 32, 3>(p, s, info);
      case 3: return run_dkv<64, 32, 4>(p, s, info);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int probe_bwd_info(int which, int variant, long long* info) {
  return dispatch(which, variant, BwdParams{}, nullptr, info);
}

// vstar_flash_attention_bwd_dq's arguments after the kernel and variant.
extern "C" int probe_bwd(int which, int variant, VSTAR_BWD_ARGS) {
  return dispatch(which, variant, VSTAR_BWD_PARAMS, static_cast<cudaStream_t>(stream),
                  nullptr);
}
