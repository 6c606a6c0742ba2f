// The register-resident attention tile of K1's tile route
// (flash_attention.cu: decoder attention over the ragged KV cache), and
// the PTX helpers (cp.async, ldmatrix, mma.sync, the online softmax step)
// that K1's split route, K2 (tower_attention.cu) and K7's two backward
// kernels (flash_attention_bwd.cu: qk_tile / qk_tile_sa, pv_tile,
// store_warp_rows) share with it.
//
// FlashAttention-2 layout: a block of BQ / 16 warps owns BQ query rows of
// one (batch, head); each warp owns 16 of them and walks the keys in
// tiles of BK rows.
//   Q      loaded once (cp.async), then held in registers as mma.sync A
//          fragments (ldmatrix)
//   S      = Q K^T in mma.sync.m16n8k16 bf16 -> f32 fragments, registers
//   masks  kv_lens, kv_valid (bytes staged beside each K/V tile) and the
//          causal column, evaluated only on tiles that straddle a bound
//   softmax online, in f32, per row across the 4-lane quad (shuffles);
//          log2 domain (exp2 of logits * scale * log2 e)
//   P      rounded to bf16 in registers: the m16n8 C fragment of S is the
//          m16n8k16 A fragment of P V, so P never leaves the registers
//   O      f32 fragments in registers, rescaled there
//   K, V   a STAGES-deep cp.async ring (16-byte cp.async.cg, tile j + 1
//          in flight while tile j computes), XOR-swizzled rows so that
//          ldmatrix (and ldmatrix.trans for V) is free of bank conflicts;
//          one block barrier per key tile
// The row strides are given per tensor, so a [B, S, H, D] tensor (a
// KV-cache layer included) is read in place; the last dimension must be
// contiguous and every row 16-byte aligned (the wrappers check both).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace vstar {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false the 16 bytes are zeros
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0));
}
// 4-byte global -> shared copy (zeros with pred false).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b: m16n8k16, bf16 operands, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16x2 (lo in the low half, as the fragments hold them).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Byte offset of 16-byte chunk c of row r in a tile of D-wide bf16 rows:
// the chunk index is XORed with r % 8, so the 8 rows an ldmatrix reads
// at one logical chunk sit in 8 different bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

// Rows [first, first + ROWS) of a [rows, D] bf16 operand (row stride rs)
// into a swizzled shared tile by cp.async, NT threads; rows at or past
// `valid` are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const bf16* __restrict__ src,
                                                long long rs, int first,
                                                int valid, int tid) {
  constexpr int CH = D / 8;
  static_assert((ROWS * CH) % NT == 0, "tile load shape");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = first + r < valid;
    const bf16* s = ok ? src + (long long)(first + r) * rs + c * 8 : src;
    cp_async16(dst + swz<D>(r, c), s, ok);
  }
}

// S (16 x 8*NS, this warp's rows) = Q K^T over D: qf holds Q's A
// fragments, kst the swizzled K tile.
template <int D, int NS>
__device__ __forceinline__ void qk_tile(float (&s)[NS][4],
                                        const uint32_t (&qf)[D / 16][4],
                                        uint32_t kst, int lane) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t b[4];
      const int key = n * 8 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, kst + swz<D>(key, kk * 2 + ((lane >> 3) & 1)));
      mma_bf16(s[n], qf[kk], b[0], b[1]);
      mma_bf16(s[n + 1], qf[kk], b[2], b[3]);
    }
  }
}

// S (16 x 8*NS) = A B^T over D with A's 16 rows read from a swizzled
// shared tile (rows arow .. arow + 15 of ast) at each k-step, instead of
// held in registers; bst is the swizzled B tile (K1's K, or Q / dO in
// the flash backward's dK/dV kernel).
template <int D, int NS>
__device__ __forceinline__ void qk_tile_sa(float (&s)[NS][4], uint32_t ast,
                                           int arow, uint32_t bst, int lane) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, ast + swz<D>(arow + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t b[4];
      const int key = n * 8 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, bst + swz<D>(key, kk * 2 + ((lane >> 3) & 1)));
      mma_bf16(s[n], a, b[0], b[1]);
      mma_bf16(s[n + 1], a, b[2], b[3]);
    }
  }
}

// Writes a warp's 16 x D f32 accumulator fragments, times `factor`, as
// bf16 rows [row0, row0 + 16) of dst (row stride rs; rows at or past
// `rows` skipped): through the warp's own rows trow .. trow + 15 of a
// swizzled shared tile `tile`, then 16-byte row stores. The caller makes
// sure nothing else reads or writes those shared rows meanwhile.
template <int D>
__device__ __forceinline__ void store_warp_rows(const float (&acc)[D / 8][4],
                                                float factor,
                                                unsigned char* tile, int trow,
                                                bf16* __restrict__ dst,
                                                long long rs, int row0,
                                                int rows, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + swz<D>(trow + g + 8 * r, n) + t4 * 4) =
          pack_bf16(acc[n][2 * r] * factor, acc[n][2 * r + 1] * factor);
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int i = lane + it * 32, r = i / CH, c = i % CH;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * rs + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(trow + r, c));
  }
}

// O (16 x D) += P V for KS k-steps of 16 keys: pf holds P's A fragments,
// vst the swizzled V tile, read transposed.
template <int D, int KS>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4],
                                        const uint32_t (&pf)[KS][4],
                                        uint32_t vst, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      const int key = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      ldmatrix_x4_trans(b, vst + swz<D>(key, dn + (lane >> 4)));
      mma_bf16(o[dn], pf[ks], b[0], b[1]);
      mma_bf16(o[dn + 1], pf[ks], b[2], b[3]);
    }
  }
}

// One online-softmax step on a warp's S fragments (already scaled to the
// log2 domain, masked entries -inf): updates the row maxima m and the
// per-thread partial row sums l (rows g and g + 8), rescales o, and
// returns P as bf16 A fragments in pf. A row that has seen no key keeps
// m = -inf, l = 0 and o = 0.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&m)[2],
                                             float (&l)[2], float (&o)[NO][4],
                                             uint32_t (&pf)[NS / 2][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float base[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    base[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r];
    alpha[r] = fast_exp2(m[r] - base[r]);   // 0 while m[r] = -inf
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const float p0 = fast_exp2(s[n][0] - base[0]);
    const float p1 = fast_exp2(s[n][1] - base[0]);
    const float p2 = fast_exp2(s[n][2] - base[1]);
    const float p3 = fast_exp2(s[n][3] - base[1]);
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
    pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

template <int D, int BQ, int BK, int STAGES>
struct TileSmem {
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + (size_t)BQ * D * 2;
  static constexpr size_t v_off = k_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t valid_off = v_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t bytes = valid_off + (size_t)STAGES * BK;
};

// Attention for query rows [q0, q0 + BQ) of one (batch, head), by
// BQ / 16 warps.
//   q, k, v, o: base pointers of this (batch, head); row r at base + r * rs
//   sq:        number of query rows
//   kv_len:    keys at columns >= kv_len are masked (kv_len <= number of keys)
//   q_off:     kv coordinate of query row 0 (causal: col <= q_off + row)
//   kv_valid:  optional per-key byte mask of this batch row, or nullptr
//   lse:       (LSE) f32 log-sum-exp of each row's scaled logits (row r at
//              lse + r * lse_rs), -inf where every key is masked; the
//              flash backward (flash_attention_bwd.cu) reads it
// A row whose keys are all masked writes zeros.
template <int D, int BQ, int BK, int STAGES, bool CAUSAL, bool LSE>
__device__ __forceinline__ void attention_tile(
    const bf16* __restrict__ q, long long q_rs, const bf16* __restrict__ k,
    long long k_rs, const bf16* __restrict__ v, long long v_rs,
    bf16* __restrict__ o, long long o_rs, int q0, int sq, int kv_len,
    int q_off, const uint8_t* __restrict__ kv_valid, float scale,
    float* __restrict__ lse, long long lse_rs) {
  static_assert(D % 64 == 0 && BQ % 16 == 0 && BK % 16 == 0 && STAGES >= 2,
                "tile shape");
  constexpr int NT = BQ / 16 * 32;
  constexpr int NS = BK / 8, NO = D / 8;
  using L = TileSmem<D, BQ, BK, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem + L::q_off);
  const uint32_t s_k = smem_u32(smem + L::k_off);
  const uint32_t s_v = smem_u32(smem + L::v_off);
  uint8_t* s_valid = smem + L::valid_off;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // Keys past the last causal column of this tile never contribute
  // (the TPU kernel's num_kv_blocks bound).
  int n_end = kv_len;
  if (CAUSAL) n_end = min(n_end, q_off + min(q0 + BQ, sq));
  const int n_tiles = n_end > 0 ? (n_end + BK - 1) / BK : 0;

  auto load_kv = [&](int j, int stage) {
    const int j0 = j * BK;
    load_tile_async<D, BK, NT>(s_k + stage * BK * D * 2, k, k_rs, j0, n_end, tid);
    load_tile_async<D, BK, NT>(s_v + stage * BK * D * 2, v, v_rs, j0, n_end, tid);
    if (kv_valid != nullptr)
      for (int c = tid; c < BK; c += NT)
        s_valid[stage * BK + c] = j0 + c < n_end ? kv_valid[j0 + c] : 0;
  };

  load_tile_async<D, BQ, NT>(s_q, q, q_rs, q0, sq, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }

  const int wrow = q0 + warp * 16;          // this warp's first query row
  const bool warp_live = wrow < sq;
  // the last kv column any row of this warp may see
  const int warp_cols = CAUSAL ? q_off + min(wrow + 15, sq - 1) + 1 : n_end;
  const int qcol0 = q_off + wrow + g;       // causal limits of rows g, g + 8
  const float sl = scale * kLog2e;

  uint32_t qf[D / 16][4];
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], s_q + swz<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
    }
    const int stage = j % STAGES, j0 = j * BK;
    if (!warp_live || j0 >= warp_cols) continue;

    float s[NS][4];
    qk_tile<D, NS>(s, qf, s_k + stage * BK * D * 2, lane);
    const bool edge = j0 + BK > kv_len || kv_valid != nullptr ||
                      (CAUSAL && j0 + BK - 1 > q_off + wrow);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl;
        if (edge) {
          const int c = n * 8 + 2 * t4 + (e & 1), col = j0 + c;
          bool ok = col < kv_len;
          if (kv_valid != nullptr) ok = ok && s_valid[stage * BK + c] != 0;
          if (CAUSAL) ok = ok && col <= qcol0 + (e >> 1) * 8;
          x = ok ? x : -CUDART_INF_F;
        }
        s[n][e] = x;
      }
    uint32_t pf[NS / 2][4];
    softmax_step<NS, NO>(s, m, l, oacc, pf);
    pv_tile<D, NS / 2>(oacc, pf, s_v + stage * BK * D * 2, lane);
  }
  // every thread's copies (the Q rows of other warps included) have
  // landed before the Q tile is reused below
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: O / l through this warp's rows of the Q tile (Q lives in
  // registers by now), then 16-byte row stores.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  __syncwarp();
  unsigned char* sq_bytes = smem + L::q_off;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(sq_bytes + swz<D>(warp * 16 + g + 8 * r, n) + t4 * 4) =
          pack_bf16(oacc[n][2 * r] * inv[r], oacc[n][2 * r + 1] * inv[r]);
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int i = lane + it * 32, r = i / CH, c = i % CH;
    if (wrow + r < sq)
      *reinterpret_cast<uint4*>(o + (long long)(wrow + r) * o_rs + c * 8) =
          *reinterpret_cast<const uint4*>(sq_bytes + swz<D>(warp * 16 + r, c));
  }
  if (LSE && t4 == 0) {
    // m + log(l), as the TPU kernel writes it (flash_attention.py:137-138);
    // l > 0 means some key was attended, so m is finite
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      if (row < sq)
        lse[(long long)row * lse_rs] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -CUDART_INF_F;
    }
  }
}

}  // namespace vstar
