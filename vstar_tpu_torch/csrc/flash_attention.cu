// K1: decoder flash attention forward for sm_90a.
//
// Replaces vstar_tpu/kernels/flash_attention.py:_fwd_kernel (the Pallas
// forward behind flash_attention). Causal softmax(Q K^T * scale) V over a
// ragged KV cache: per batch row, keys at or past kv_lens[b] are masked,
// an optional kv_valid byte mask drops single keys, and query row i sits
// at kv column q_offsets[b] + i. Rows with every key masked give zeros.
//
// What bounds it on the H100: decode (Sq = 1) and short verify/option
// chunks read the whole cache of each (batch, head) for a handful of
// query rows, so they are bound by KV bytes; prefill (Sq = 384..768) is
// bound by the 4*Sq*Skv*D operations of each head. The design reads the
// cache in place through its strides (no transpose, no copy), stops at
// the last causal column and at kv_lens, and picks the query tile by Sq:
// 16 rows for decode and verify chunks (the smallest WMMA tile), 64 rows
// otherwise. Everything between the input loads and the output store
// stays in shared memory.
//
// For training, the caller may also ask for each row's log-sum-exp (f32
// [B, Sq, H], explicit strides; the TPU forward's second output), which
// the backward (flash_attention_bwd.cu) needs. That is a separate
// instantiation (LSE = true), so the serving kernel, which passes
// nullptr, compiles to the code it had without it.
#include "attention_common.cuh"

namespace {

using vstar::bf16;

constexpr int kD = 128;
constexpr int kBK = 64;

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kv_lens;
  const int* q_offsets;
  const uint8_t* kv_valid;  // [B, Skv] bytes, or nullptr
  float* lse;               // [B, Sq, H] f32, or nullptr
  long long b, sq, skv, h;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long valid_sb;
  long long lse_sb, lse_ss, lse_sh;
  float scale;
};

template <int BQ, bool LSE>
__global__ void __launch_bounds__(vstar::kThreads)
    flash_fwd_kernel(const FlashParams p) {
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kv_len = max(0, min(p.kv_lens[b], (int)p.skv));
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  vstar::attention_tile<kD, BQ, kBK>(
      p.q + b * p.q_sb + h * p.q_sh, p.q_ss, p.k + b * p.k_sb + h * p.k_sh,
      p.k_ss, p.v + b * p.v_sb + h * p.v_sh, p.v_ss,
      p.o + b * p.o_sb + h * p.o_sh, p.o_ss, q0, (int)p.sq, kv_len,
      p.q_offsets[b], valid, true, p.scale,
      LSE ? p.lse + b * p.lse_sb + h * p.lse_sh : nullptr, p.lse_ss);
}

template <int BQ, bool LSE>
int launch(const FlashParams& p, cudaStream_t stream) {
  constexpr size_t smem = vstar::Smem<kD, BQ, kBK>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<BQ, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((p.sq + BQ - 1) / BQ), (unsigned)p.h, (unsigned)p.b);
  flash_fwd_kernel<BQ, LSE><<<grid, vstar::kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vstar_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kv_lens,
    const void* q_offsets, const void* kv_valid, void* lse, long long b,
    long long sq, long long skv, long long h, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long valid_sb, long long lse_sb, long long lse_ss,
    long long lse_sh, float scale, void* stream) {
  FlashParams p{static_cast<const bf16*>(q),
                static_cast<const bf16*>(k),
                static_cast<const bf16*>(v),
                static_cast<bf16*>(o),
                static_cast<const int*>(kv_lens),
                static_cast<const int*>(q_offsets),
                static_cast<const uint8_t*>(kv_valid),
                static_cast<float*>(lse),
                b, sq, skv, h,
                q_sb, q_ss, q_sh,
                k_sb, k_ss, k_sh,
                v_sb, v_ss, v_sh,
                o_sb, o_ss, o_sh,
                valid_sb,
                lse_sb, lse_ss, lse_sh,
                scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr)
    return sq <= 16 ? launch<16, true>(p, s) : launch<64, true>(p, s);
  return sq <= 16 ? launch<16, false>(p, s) : launch<64, false>(p, s);
}

extern "C" const char* vstar_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
