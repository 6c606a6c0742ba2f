// Block-level attention tile shared by the port's two attention kernels
// (flash_attention.cu: decoder attention over the ragged KV cache;
// tower_attention.cu: full attention inside the OWL-ViT tower).
//
// One block of kThreads threads owns BQ query rows of one (batch, head)
// and walks the keys in tiles of BK rows:
//   S = Q K^T      bf16 WMMA 16x16x16, f32 accumulate, written to shared
//   online softmax in f32, one warp per row (masks applied here)
//   O = O*alpha + P V   P rounded to bf16, bf16 WMMA, O kept in shared f32
// Q, K, V, S, P and O all live in shared memory, so nothing but the
// inputs and the output touches device memory. The row strides are given
// per tensor, so a [B, S, H, D] tensor (a KV-cache layer included) is read
// in place; the last dimension must be contiguous and every row 16-byte
// aligned (the wrappers check both).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace vstar {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Shared-memory layout. Row strides are padded (+8 bf16 / +4 f32) against
// bank conflicts; every region and every 16-row fragment start stays
// 32-byte aligned, as load/store_matrix_sync require.
template <int D, int BQ, int BK>
struct Smem {
  static constexpr int LDH = D + 8;   // bf16 Q, K, V rows
  static constexpr int LDS = BK + 4;  // f32 S rows
  static constexpr int LDP = BK + 8;  // bf16 P rows
  static constexpr int LDO = D + 4;   // f32 O rows
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t s_off = v_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t row_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t bytes = row_off + sizeof(float) * 3 * BQ;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copies `rows` rows of D bf16 (16 bytes per thread and step) into a
// shared tile of `tile_rows` rows; rows at or past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst, int ld,
                                          const bf16* __restrict__ src,
                                          long long src_rs, int first,
                                          int tile_rows, int valid) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < tile_rows * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (long long)(first + r) * src_rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Attention for query rows [q0, q0 + BQ) of one (batch, head).
//   q, k, v, o: base pointers of this (batch, head); row r at base + r * rs
//   sq:        number of query rows
//   kv_len:    keys at columns >= kv_len are masked (kv_len <= number of keys)
//   q_off:     kv coordinate of query row 0 (causal: col <= q_off + row)
//   kv_valid:  optional per-key byte mask of this batch row, or nullptr
//   lse:       optional f32 log-sum-exp of each row's scaled logits (row r
//              at lse + r * lse_rs), -inf where every key is masked; the
//              flash backward (flash_attention_bwd.cu) reads it
// A row whose keys are all masked writes zeros.
template <int D, int BQ, int BK>
__device__ void attention_tile(const bf16* __restrict__ q, long long q_rs,
                               const bf16* __restrict__ k, long long k_rs,
                               const bf16* __restrict__ v, long long v_rs,
                               bf16* __restrict__ o, long long o_rs, int q0,
                               int sq, int kv_len, int q_off,
                               const uint8_t* __restrict__ kv_valid,
                               bool causal, float scale,
                               float* __restrict__ lse = nullptr,
                               long long lse_rs = 0) {
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 32 == 0, "tile shape");
  using L = Smem<D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::row_off);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  load_rows<D>(Qs, L::LDH, q, q_rs, q0, BQ, sq);
  for (int i = tid; i < BQ * L::LDO; i += kThreads) Os[i] = 0.f;
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = -CUDART_INF_F;
    l_s[r] = 0.f;
  }

  // Keys past the last causal column of this tile never contribute
  // (the TPU kernel's num_kv_blocks bound).
  int n_end = kv_len;
  if (causal) n_end = min(n_end, q_off + min(q0 + BQ, sq));
  __syncthreads();

  for (int j0 = 0; j0 < n_end; j0 += BK) {
    load_rows<D>(Ks, L::LDH, k, k_rs, j0, BK, n_end);
    load_rows<D>(Vs, L::LDH, v, v_rs, j0, BK, n_end);
    __syncthreads();

    // S = Q K^T
    constexpr int SF_COLS = BK / 16;
    for (int f = warp; f < (BQ / 16) * SF_COLS; f += kWarps) {
      const int fr = f / SF_COLS, fc = f % SF_COLS;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + fr * 16 * L::LDH + kk, L::LDH);
        wmma::load_matrix_sync(b, Ks + fc * 16 * L::LDH + kk, L::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + fr * 16 * L::LDS + fc * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // Online softmax, one warp per row, BK / 32 columns per lane.
    for (int r = warp; r < BQ; r += kWarps) {
      const int row = q_off + q0 + r;
      float s[BK / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const int c = lane + 32 * t, col = j0 + c;
        bool ok = col < kv_len;
        if (ok && kv_valid != nullptr) ok = kv_valid[col] != 0;
        if (ok && causal) ok = col <= row;
        s[t] = ok ? Ss[r * L::LDS + c] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[t]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const float p = s[t] == -CUDART_INF_F ? 0.f : __expf(s[t] - m_safe);
        Ps[r * L::LDP + lane + 32 * t] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_prev == -CUDART_INF_F ? 0.f : __expf(m_prev - m_safe);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * D; i += kThreads) {
      const int r = i / D, c = i % D;
      Os[r * L::LDO + c] *= a_s[r];
    }
    __syncthreads();

    // O += P V
    constexpr int OF_COLS = D / 16;
    for (int f = warp; f < (BQ / 16) * OF_COLS; f += kWarps) {
      const int fr = f / OF_COLS, fc = f % OF_COLS;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* optr = Os + fr * 16 * L::LDO + fc * 16;
      wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + fr * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(b, Vs + kk * L::LDH + fc * 16, L::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < sq)
      o[(long long)(q0 + r) * o_rs + c] =
          __float2bfloat16(Os[r * L::LDO + c] / fmaxf(l_s[r], 1e-30f));
  }
  if (lse != nullptr) {
    // m + log(l), as the TPU kernel writes it (flash_attention.py:137-138);
    // l > 0 means some key was attended, so m is finite
    for (int r = tid; r < BQ; r += kThreads) {
      if (q0 + r >= sq) continue;
      const float l = l_s[r];
      lse[(long long)(q0 + r) * lse_rs] =
          l > 0.f ? m_s[r] + logf(l) : -CUDART_INF_F;
    }
  }
}

}  // namespace vstar
