// K1's tile route at other shapes than the shipped one, for
// attention_probe.py --tiles: vstar::attention_tile instantiated at each
// (query rows BQ, key tile BK, cp.async stages, minimum resident blocks)
// of VARIANTS. Built apart from the kernel library, which it includes
// whole (FlashParams and the shipped launchers come from there).
#include "../csrc/flash_attention.cu"

// The library's K2 and K7 halves are not linked into the probe.
extern "C" int vstar_tower_kernel_info(int, const char**, long long*) { return -1; }
extern "C" int vstar_bwd_kernel_info(int, const char**, long long*) { return -1; }

namespace {

template <int BQ, int BK, int ST, int MINB, bool LSE>
__global__ void __launch_bounds__(BQ * 2, MINB) probe_kernel(const FlashParams p) {
  const long long b = blockIdx.z, h = blockIdx.y;
  const int kv_len = max(0, min(p.kv_lens[b], (int)p.skv));
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  vstar::attention_tile<kD, BQ, BK, ST, true, LSE>(
      p.q + b * p.q_sb + h * p.q_sh, p.q_ss, p.k + b * p.k_sb + h * p.k_sh,
      p.k_ss, p.v + b * p.v_sb + h * p.v_sh, p.v_ss,
      p.o + b * p.o_sb + h * p.o_sh, p.o_ss, blockIdx.x * BQ, (int)p.sq,
      kv_len, p.q_offsets[b], valid, p.scale,
      LSE ? p.lse + b * p.lse_sb + h * p.lse_sh : nullptr, p.lse_ss);
}

// Launches the variant, or with info != nullptr reports its registers,
// local bytes and resident blocks per SM instead.
template <int BQ, int BK, int ST, int MINB, bool LSE>
int run(const FlashParams& p, cudaStream_t s, int* info) {
  constexpr size_t smem = vstar::TileSmem<kD, BQ, BK, ST>::bytes;
  auto kernel = probe_kernel<BQ, BK, ST, MINB, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, BQ * 2, smem);
  }
  dim3 grid((unsigned)((p.sq + BQ - 1) / BQ), (unsigned)p.h, (unsigned)p.b);
  kernel<<<grid, BQ * 2, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The order of attention_probe.py's VARIANTS.
template <bool LSE>
int dispatch(int v, const FlashParams& p, cudaStream_t s, int* info) {
  switch (v) {
    case 0: return run<64, 64, 2, 1, LSE>(p, s, info);    // shipped
    case 1: return run<128, 64, 2, 1, LSE>(p, s, info);
    case 2: return run<64, 64, 3, 1, LSE>(p, s, info);
    case 3: return run<64, 32, 2, 1, LSE>(p, s, info);
    case 4: return run<64, 32, 3, 1, LSE>(p, s, info);
    case 5: return run<64, 32, 4, 2, LSE>(p, s, info);
    case 6: return run<64, 128, 2, 1, LSE>(p, s, info);
    case 7: return run<64, 64, 2, 3, LSE>(p, s, info);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int probe_info(int variant, int* info) {
  return dispatch<true>(variant, FlashParams{}, nullptr, info);
}

// vstar_flash_attention_fwd's arguments, with the variant in the place
// of n_splits.
extern "C" int probe_tile(
    const void* q, const void* k, const void* v, void* o, const void* kv_lens,
    const void* q_offsets, const void* kv_valid, void* lse, void* ws_o,
    void* ws_ml, long long variant, long long b, long long sq, long long skv,
    long long h, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long valid_sb, long long lse_sb, long long lse_ss, long long lse_sh,
    float scale, void* stream) {
  FlashParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o),
                static_cast<const int*>(kv_lens), static_cast<const int*>(q_offsets),
                static_cast<const uint8_t*>(kv_valid), static_cast<float*>(lse),
                static_cast<float*>(ws_o), static_cast<float*>(ws_ml),
                b, sq, skv, h, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, valid_sb, lse_sb, lse_ss, lse_sh,
                scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lse != nullptr ? dispatch<true>((int)variant, p, s, nullptr)
                        : dispatch<false>((int)variant, p, s, nullptr);
}
