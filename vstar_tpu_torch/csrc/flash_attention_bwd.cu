// K7: flash-attention backward for sm_90a.
//
// Replaces vstar_tpu/kernels/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (the Pallas backward behind flash_attention's
// custom_vjp). From q, k, v and dO (bf16 [B, S, H, D]), the forward's row
// log-sum-exp `lse` and delta = sum_d dO * O (f32 [B, Sq, H]), under K1's
// masks (causal, kv_lens, q_offsets, kv_valid):
//   P  = exp(Q K^T * scale - lse)    0 where masked
//   dP = dO V^T,   dS = P * (dP - delta)
//   dQ = dS K * scale,   dK = dS^T Q * scale,   dV = P^T dO
// Two kernels, as on the TPU. One block per (query tile, head, batch row)
// sums dQ over the key tiles up to its causal limit and kv_lens; one block
// per (key tile, head, batch row) sums dK and dV over the query tiles from
// the first one that sees its keys. Every output element is written by
// one block and there are no atomics, so the result is deterministic. A
// row whose keys are all masked has lse = -inf and gets P = 0 without
// forming exp(-inf + inf); masked keys get dK = dV = 0.
//
// What bounds it on the H100: at the training shape [4, 512, 32, 128] the
// five products (2 * Sq * Skv * D operations each per head, halved by
// causality), about 2.1e10 operations, take 0.022 ms at the bf16 peak;
// q, k, v, dO read and dq, dk, dv written are 117 MB, 0.035 ms at
// 3.35 TB/s: bytes, by a little. The design keeps every intermediate (S,
// P, dP, dS and the f32 accumulators) in shared memory, so device memory
// sees each block's inputs once and its outputs once. The products are
// bf16 WMMA with f32 accumulation; P and dS are rounded to bf16 before
// their products.
#include <type_traits>

#include "attention_common.cuh"

namespace {

using vstar::bf16;
namespace wmma = nvcuda::wmma;

constexpr int kD = 128;        // head width
constexpr int kB = 64;         // rows of a query tile and of a key tile
constexpr int kNT = 256;       // threads per block
constexpr int kNW = kNT / 32;  // warps per block

// Shared-memory row strides, padded against bank conflicts; every tile
// and every 16-row fragment start stays 32-byte aligned, as WMMA needs.
constexpr int LDH = kD + 8;  // bf16 rows of Q, K, V, dO
constexpr int LDS = kB + 4;  // f32 rows of S, dP
constexpr int LDP = kB + 8;  // bf16 rows of P, dS
constexpr int LDA = kD + 4;  // f32 rows of the accumulators

constexpr size_t kTileH = sizeof(bf16) * kB * LDH;
constexpr size_t kTileS = sizeof(float) * kB * LDS;
constexpr size_t kTileP = sizeof(bf16) * kB * LDP;
constexpr size_t kTileA = sizeof(float) * kB * LDA;
constexpr size_t kRows = sizeof(float) * 3 * kB;  // lse, delta, key mask

// dQ: Q, dO, K, V | S, dP | dS | dQ | rows
constexpr size_t kSmemDq = 4 * kTileH + 2 * kTileS + kTileP + kTileA + kRows;
// dK/dV: K, V, Q, dO | S, dP | P, dS | dK, dV | rows
constexpr size_t kSmemDkv =
    4 * kTileH + 2 * kTileS + 2 * kTileP + 2 * kTileA + kRows;

struct BwdParams {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;  // [B, Sq, H]; delta has lse's strides
  bf16 *dq, *dk, *dv;
  const int *kv_lens, *q_offsets;
  const uint8_t* kv_valid;  // [B, Skv] bytes, or nullptr
  long long b, sq, skv, h;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  long long lse_sb, lse_ss, lse_sh;
  long long valid_sb;
  float scale;
};

// Rows [first, first + kB) of a [rows, kD] bf16 operand (row stride rs)
// into a shared tile, 16 bytes per thread and step; rows at or past
// `valid` are zero.
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src,
                                          long long rs, int first,
                                          int valid) {
  constexpr int CH = kD / 8;
  for (int i = threadIdx.x; i < kB * CH; i += kNT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)(first + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// The lse and delta of query rows [q0, q0 + kB); rows past sq read as
// fully masked (lse = -inf).
__device__ __forceinline__ void load_rows(float* __restrict__ lse_s,
                                          float* __restrict__ delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          long long rs, int q0, int sq) {
  for (int r = threadIdx.x; r < kB; r += kNT) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? lse[(long long)(q0 + r) * rs] : -CUDART_INF_F;
    delta_s[r] = in ? delta[(long long)(q0 + r) * rs] : 0.f;
  }
}

// 1 for the keys [k0, k0 + kB) that are below kv_len and valid, else 0.
__device__ __forceinline__ void load_key_mask(float* __restrict__ key_ok,
                                              int k0, int kv_len,
                                              const uint8_t* __restrict__ valid) {
  for (int c = threadIdx.x; c < kB; c += kNT) {
    const int col = k0 + c;
    key_ok[c] = col < kv_len && (valid == nullptr || valid[col] != 0) ? 1.f : 0.f;
  }
}

// C [kB x kB] f32 = A B^T for two [kB x kD] bf16 tiles (the rows of A and
// of B are the product's rows and columns).
__device__ __forceinline__ void mm_abt(float* __restrict__ C,
                                       const bf16* __restrict__ A,
                                       const bf16* __restrict__ B) {
  constexpr int NF = kB / 16;
  for (int f = threadIdx.x / 32; f < NF * NF; f += kNW) {
    const int fr = f / NF, fc = f % NF;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + fr * 16 * LDH + kk, LDH);
      wmma::load_matrix_sync(b, B + fc * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + fr * 16 * LDS + fc * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// Acc [kB x kD] f32 += op(A) B, A a [kB x kB] bf16 tile of row stride LDP
// (op = transpose when TRANS_A), B a [kB x kD] bf16 tile.
template <bool TRANS_A>
__device__ __forceinline__ void mm_acc(float* __restrict__ acc_s,
                                       const bf16* __restrict__ A,
                                       const bf16* __restrict__ B) {
  using LayoutA = std::conditional_t<TRANS_A, wmma::col_major, wmma::row_major>;
  constexpr int NR = kB / 16, NC = kD / 16;
  for (int f = threadIdx.x / 32; f < NR * NC; f += kNW) {
    const int fr = f / NC, fc = f % NC;
    float* out = acc_s + fr * 16 * LDA + fc * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, out, LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(
          a, TRANS_A ? A + kk * LDP + fr * 16 : A + fr * 16 * LDP + kk, LDP);
      wmma::load_matrix_sync(b, B + kk * LDH + fc * 16, LDH);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out, acc, LDA, wmma::mem_row_major);
  }
}

// P and dS of one (query tile, key tile) pair from S and dP: rows are
// queries at kv coordinate row0 + r, columns keys at col0 + c. P is
// written only when P_out is given (the dQ kernel needs dS alone).
__device__ __forceinline__ void probs_and_grads(
    const float* __restrict__ S, const float* __restrict__ dP,
    const float* __restrict__ lse_s, const float* __restrict__ delta_s,
    const float* __restrict__ key_ok, bf16* __restrict__ P_out,
    bf16* __restrict__ dS_out, int row0, int col0, float scale) {
  for (int i = threadIdx.x; i < kB * kB; i += kNT) {
    const int r = i / kB, c = i % kB;
    const float l = lse_s[r];
    const bool ok = key_ok[c] != 0.f && col0 + c <= row0 + r && l != -CUDART_INF_F;
    const float p = ok ? expf(S[r * LDS + c] * scale - l) : 0.f;
    const float ds = p * (dP[r * LDS + c] - delta_s[r]);
    if (P_out != nullptr) P_out[r * LDP + c] = __float2bfloat16(p);
    dS_out[r * LDP + c] = __float2bfloat16(ds);
  }
}

__global__ void __launch_bounds__(kNT) flash_bwd_dq_kernel(const BwdParams p) {
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + kTileH);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * kTileH);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * kTileH);
  float* Ss = reinterpret_cast<float*>(smem + 4 * kTileH);
  float* dPs = reinterpret_cast<float*>(smem + 4 * kTileH + kTileS);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * kTileH + 2 * kTileS);
  float* acc = reinterpret_cast<float*>(smem + 4 * kTileH + 2 * kTileS + kTileP);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * kTileH + 2 * kTileS + kTileP + kTileA);
  float* delta_s = lse_s + kB;
  float* key_ok = delta_s + kB;

  const int sq = (int)p.sq;
  const int kv_len = max(0, min(p.kv_lens[b], (int)p.skv));
  const int q_off = p.q_offsets[b];
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;

  load_tile(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, sq);
  load_tile(dOs, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0, sq);
  load_rows(lse_s, delta_s, p.lse + b * p.lse_sb + h * p.lse_sh,
            p.delta + b * p.lse_sb + h * p.lse_sh, p.lse_ss, q0, sq);
  for (int i = threadIdx.x; i < kB * LDA; i += kNT) acc[i] = 0.f;
  // keys past the tile's last causal column never contribute (the TPU
  // kernel's num_kv_blocks bound)
  const int n_end = min(kv_len, q_off + min(q0 + kB, sq));
  __syncthreads();

  for (int j0 = 0; j0 < n_end; j0 += kB) {
    load_tile(Ks, k, p.k_ss, j0, n_end);
    load_tile(Vs, v, p.v_ss, j0, n_end);
    load_key_mask(key_ok, j0, kv_len, valid);
    __syncthreads();
    mm_abt(Ss, Qs, Ks);
    mm_abt(dPs, dOs, Vs);
    __syncthreads();
    probs_and_grads(Ss, dPs, lse_s, delta_s, key_ok, nullptr, dSs, q_off + q0,
                    j0, p.scale);
    __syncthreads();
    mm_acc<false>(acc, dSs, Ks);
    __syncthreads();
  }

  bf16* dq = p.dq + b * p.dq_sb + h * p.dq_sh;
  for (int i = threadIdx.x; i < kB * kD; i += kNT) {
    const int r = i / kD, c = i % kD;
    if (q0 + r < sq)
      dq[(long long)(q0 + r) * p.dq_ss + c] = __float2bfloat16(acc[r * LDA + c] * p.scale);
  }
}

__global__ void __launch_bounds__(kNT) flash_bwd_dkv_kernel(const BwdParams p) {
  const long long b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + kTileH);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * kTileH);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * kTileH);
  float* Ss = reinterpret_cast<float*>(smem + 4 * kTileH);
  float* dPs = reinterpret_cast<float*>(smem + 4 * kTileH + kTileS);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 4 * kTileH + 2 * kTileS);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 4 * kTileH + 2 * kTileS + kTileP);
  float* dK = reinterpret_cast<float*>(smem + 4 * kTileH + 2 * kTileS + 2 * kTileP);
  float* dV = dK + kB * LDA;
  float* lse_s = dV + kB * LDA;
  float* delta_s = lse_s + kB;
  float* key_ok = delta_s + kB;

  const int sq = (int)p.sq, skv = (int)p.skv;
  const int kv_len = max(0, min(p.kv_lens[b], skv));
  const int q_off = p.q_offsets[b];
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + b * p.lse_sb + h * p.lse_sh;
  const float* delta = p.delta + b * p.lse_sb + h * p.lse_sh;

  load_tile(Ks, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0, skv);
  load_tile(Vs, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0, skv);
  load_key_mask(key_ok, k0, kv_len, valid);
  for (int i = threadIdx.x; i < 2 * kB * LDA; i += kNT) dK[i] = 0.f;
  // query rows whose kv coordinate is below this key tile never attend
  // to it (the TPU kernel's start_q_block); a tile of keys all at or
  // past kv_len has nothing to do
  const int nqb = (sq + kB - 1) / kB;
  int start = k0 - q_off > 0 ? min(nqb, (k0 - q_off) / kB) : 0;
  if (k0 >= kv_len) start = nqb;
  __syncthreads();

  for (int qt = start; qt < nqb; ++qt) {
    const int q0 = qt * kB;
    load_tile(Qs, q, p.q_ss, q0, sq);
    load_tile(dOs, dout, p.do_ss, q0, sq);
    load_rows(lse_s, delta_s, lse, delta, p.lse_ss, q0, sq);
    __syncthreads();
    mm_abt(Ss, Qs, Ks);
    mm_abt(dPs, dOs, Vs);
    __syncthreads();
    probs_and_grads(Ss, dPs, lse_s, delta_s, key_ok, Ps, dSs, q_off + q0, k0,
                    p.scale);
    __syncthreads();
    mm_acc<true>(dV, Ps, dOs);
    mm_acc<true>(dK, dSs, Qs);
    __syncthreads();
  }

  bf16* dk = p.dk + b * p.dk_sb + h * p.dk_sh;
  bf16* dv = p.dv + b * p.dv_sb + h * p.dv_sh;
  for (int i = threadIdx.x; i < kB * kD; i += kNT) {
    const int r = i / kD, c = i % kD;
    if (k0 + r < skv) {
      dk[(long long)(k0 + r) * p.dk_ss + c] = __float2bfloat16(dK[r * LDA + c] * p.scale);
      dv[(long long)(k0 + r) * p.dv_ss + c] = __float2bfloat16(dV[r * LDA + c]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, long long tiles, const BwdParams& p,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)tiles, (unsigned)p.h, (unsigned)p.b);
  kernel<<<grid, kNT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points take the same arguments: every pointer, then B, Sq,
// Skv, H, the (batch, row, head) strides of q, k, v, dO, dq, dk, dv and
// lse (delta shares lse's), kv_valid's batch stride, the scale and the
// stream. The dQ kernel writes dq only; the dK/dV kernel dk and dv only.
#define VSTAR_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *delta, void *dq, void *dk, void *dv,      \
      const void *kv_lens, const void *q_offsets, const void *kv_valid,      \
      long long b, long long sq, long long skv, long long h, long long q_sb, \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,        \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,        \
      long long do_sb, long long do_ss, long long do_sh, long long dq_sb,    \
      long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,    \
      long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,    \
      long long lse_sb, long long lse_ss, long long lse_sh,                  \
      long long valid_sb, float scale, void *stream

#define VSTAR_BWD_PARAMS                                                      \
  BwdParams {                                                                \
    static_cast<const bf16*>(q), static_cast<const bf16*>(k),                \
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),         \
        static_cast<const float*>(lse), static_cast<const float*>(delta),    \
        static_cast<bf16*>(dq), static_cast<bf16*>(dk),                      \
        static_cast<bf16*>(dv), static_cast<const int*>(kv_lens),            \
        static_cast<const int*>(q_offsets),                                  \
        static_cast<const uint8_t*>(kv_valid), b, sq, skv, h, q_sb, q_ss,    \
        q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,       \
        dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh,       \
        lse_sb, lse_ss, lse_sh, valid_sb, scale                              \
  }

extern "C" int vstar_flash_attention_bwd_dq(VSTAR_BWD_ARGS) {
  return launch(flash_bwd_dq_kernel, kSmemDq, (sq + kB - 1) / kB,
                VSTAR_BWD_PARAMS, stream);
}

extern "C" int vstar_flash_attention_bwd_dkv(VSTAR_BWD_ARGS) {
  return launch(flash_bwd_dkv_kernel, kSmemDkv, (skv + kB - 1) / kB,
                VSTAR_BWD_PARAMS, stream);
}
