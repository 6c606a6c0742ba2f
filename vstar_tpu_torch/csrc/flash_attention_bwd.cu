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
// Two kernels, as on the TPU, each output element written by one block,
// no atomics, so the result is the same bit for bit from one launch to
// the next. A row with lse = -inf gets P = 0 (its log2-domain lse is
// taken as +inf, so exp2(s - inf) = 0 and exp(-inf + inf) is never
// formed); masked keys get dK = dV = 0.
//
// What bounds it on the H100: at the training shape [4, 512, 32, 128]
// the five products (2 * D operations per unmasked (query, key) pair
// each), ~2.2e10 operations, take 0.022 ms at the bf16 peak; q, k, v, dO
// read and dq, dk, dv written are 117 MB, 0.035 ms at 3.35 TB/s: bytes,
// by a little. Both kernels recompute S and dP (seven products in all,
// against five with atomics), so the tensor cores, not the bytes, set
// the pace in practice.
//
// Design (K1's register-resident tile, attention_common.cuh): mma.sync
// m16n8k16 bf16 with f32 accumulation; every intermediate stays in
// registers; the m16n8 C fragments of P and dS are the A fragments of the
// next products, so P and dS never touch shared memory; operands stream
// through a swizzled cp.async ring with one block barrier per tile; masks
// are evaluated only on tiles that straddle a bound.
//
//   dQ   a block owns BQ query rows of one (batch, head), a warp 16 of
//        them; Q and dO are A fragments in registers, lse and delta two
//        registers per row. K/V tiles of BK keys (with their kv_valid
//        bytes) stream through the ring. S = Q K^T and dP = dO V^T
//        (qk_tile, V in K's place), P = exp2(S * scale * log2 e - lse *
//        log2 e), dS = P (dP - delta) rounded to bf16 A fragments, and
//        dQ += dS K reads K by ldmatrix.trans (pv_tile, K in V's place).
//        Key tiles stop at the tile's last causal column (the TPU's
//        num_kv_blocks bound, `n_end`). Blocks are issued last query tile
//        first: those have the most keys.
//   dK/dV a block owns BK keys, a warp 16 of them; K and V stay in a
//        resident shared tile and are read by ldmatrix at each k-step
//        (qk_tile_sa), which keeps the two 16 x 128 f32 accumulators (128
//        registers a thread) from spilling. S^T = K Q^T and dP^T = V dO^T
//        put the keys in the M rows, so P^T and dS^T come out in key-row
//        layout and dV += P^T dO, dK += dS^T Q take them as A fragments
//        straight from registers, reading dO and Q by ldmatrix.trans.
//        Query tiles of BQ rows stream through the ring with their lse
//        and delta (per column here) beside them, from the first tile
//        that sees the block's keys (the TPU's start_q_block, `start`).
//
// cudaFuncSetAttribute runs once per instantiation (`prepare`), not on
// every launch. Tile sizes and stages (VSTAR_DQ_TILE, VSTAR_DKV_TILE:
// 64 / 64 / 2 for both) were chosen by measurement
// (vstar_tpu_torch/scripts/kernel_probe.py --k7-tiles; PERF.md).
#include "attention_common.cuh"

namespace {

using vstar::bf16;

constexpr int kD = 128;  // head width

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

// dQ: the Q and dO tiles, then STAGES (K, V) tiles and their kv_valid
// bytes.
template <int BQ, int BK, int STAGES>
struct DqSmem {
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + (size_t)BQ * kD * 2;
  static constexpr size_t k_off = do_off + (size_t)BQ * kD * 2;
  static constexpr size_t v_off = k_off + (size_t)STAGES * BK * kD * 2;
  static constexpr size_t valid_off = v_off + (size_t)STAGES * BK * kD * 2;
  static constexpr size_t bytes = valid_off + (size_t)STAGES * BK;
};

// dK/dV: the resident K and V tiles, then STAGES (Q, dO) tiles and their
// lse and delta.
template <int BK, int BQ, int STAGES>
struct DkvSmem {
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + (size_t)BK * kD * 2;
  static constexpr size_t q_off = v_off + (size_t)BK * kD * 2;
  static constexpr size_t do_off = q_off + (size_t)STAGES * BQ * kD * 2;
  static constexpr size_t lse_off = do_off + (size_t)STAGES * BQ * kD * 2;
  static constexpr size_t delta_off = lse_off + (size_t)STAGES * BQ * 4;
  static constexpr size_t bytes = delta_off + (size_t)STAGES * BQ * 4;
};

// The log2-domain lse of a row: +inf for a row that sees no key (lse =
// -inf), so that exp2(s * scale * log2 e - it) is 0.
__device__ __forceinline__ float lse_log2(float l) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * vstar::kLog2e;
}

template <int BQ, int BK, int STAGES>
__global__ void __launch_bounds__(BQ * 2)
    flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && STAGES >= 2, "tile shape");
  constexpr int NT = BQ * 2, NS = BK / 8, NO = kD / 8;
  using L = DqSmem<BQ, BK, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = vstar::smem_u32(smem + L::q_off);
  const uint32_t s_do = vstar::smem_u32(smem + L::do_off);
  const uint32_t s_k = vstar::smem_u32(smem + L::k_off);
  const uint32_t s_v = vstar::smem_u32(smem + L::v_off);
  uint8_t* s_valid = smem + L::valid_off;
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // most keys first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int sq = (int)p.sq;
  const int kv_len = max(0, min(p.kv_lens[b], (int)p.skv));
  const int q_off = p.q_offsets[b];
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;

  // keys past the tile's last causal column never contribute (the TPU
  // kernel's num_kv_blocks bound)
  const int n_end = min(kv_len, q_off + min(q0 + BQ, sq));
  const int n_tiles = n_end > 0 ? (n_end + BK - 1) / BK : 0;
  auto load_kv = [&](int j, int stage) {
    const int j0 = j * BK;
    vstar::load_tile_async<kD, BK, NT>(s_k + stage * BK * kD * 2, k, p.k_ss, j0, n_end, tid);
    vstar::load_tile_async<kD, BK, NT>(s_v + stage * BK * kD * 2, v, p.v_ss, j0, n_end, tid);
    if (valid != nullptr)
      for (int c = tid; c < BK; c += NT)
        s_valid[stage * BK + c] = j0 + c < n_end ? valid[j0 + c] : 0;
  };

  vstar::load_tile_async<kD, BQ, NT>(s_q, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, sq, tid);
  vstar::load_tile_async<kD, BQ, NT>(s_do, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, q0,
                                     sq, tid);
  vstar::cp_async_commit();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    vstar::cp_async_commit();
  }

  // rows g and g + 8 of this warp: log2-domain lse (+inf past sq) and delta
  const int wrow = q0 + warp * 16;
  const float* lse = p.lse + b * p.lse_sb + h * p.lse_sh;
  const float* delta = p.delta + b * p.lse_sb + h * p.lse_sh;
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    const bool in = row < sq;
    nl[r] = lse_log2(in ? lse[(long long)row * p.lse_ss] : -CUDART_INF_F);
    dl[r] = in ? delta[(long long)row * p.lse_ss] : 0.f;
  }

  vstar::cp_async_wait<STAGES - 1>();   // the Q / dO group has landed
  __syncthreads();
  uint32_t qf[kD / 16][4], df[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = vstar::swz<kD>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4));
    vstar::ldmatrix_x4(qf[kk], s_q + off);
    vstar::ldmatrix_x4(df[kk], s_do + off);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool warp_live = wrow < sq;
  // the last kv column any row of this warp may see, plus one
  const int warp_cols = q_off + min(wrow + 15, sq - 1) + 1;
  const int qcol0 = q_off + wrow + g;   // causal limits of rows g, g + 8
  const float sl = p.scale * vstar::kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    vstar::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    vstar::cp_async_commit();
    const int stage = j % STAGES, j0 = j * BK;
    if (!warp_live || j0 >= warp_cols) continue;
    const uint32_t kst = s_k + stage * BK * kD * 2;
    float s[NS][4], dp[NS][4];
    vstar::qk_tile<kD, NS>(s, qf, kst, lane);
    vstar::qk_tile<kD, NS>(dp, df, s_v + stage * BK * kD * 2, lane);
    const bool edge = j0 + BK > kv_len || valid != nullptr || j0 + BK - 1 > q_off + wrow;
    uint32_t dsf[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = vstar::fast_exp2(s[n][e] * sl - nl[e >> 1]);
        if (edge) {
          const int c = n * 8 + 2 * t4 + (e & 1), col = j0 + c;
          bool ok = col < kv_len && col <= qcol0 + (e >> 1) * 8;
          if (valid != nullptr) ok = ok && s_valid[stage * BK + c] != 0;
          pr = ok ? pr : 0.f;
        }
        ds[e] = pr * (dp[n][e] - dl[e >> 1]);
      }
      dsf[n / 2][(n & 1) * 2] = vstar::pack_bf16(ds[0], ds[1]);
      dsf[n / 2][(n & 1) * 2 + 1] = vstar::pack_bf16(ds[2], ds[3]);
    }
    vstar::pv_tile<kD, NS / 2>(acc, dsf, kst, lane);
  }
  vstar::cp_async_wait<0>();
  __syncthreads();
  // the warp's own rows of the Q tile (Q lives in registers by now)
  vstar::store_warp_rows<kD>(acc, p.scale, smem + L::q_off, warp * 16,
                             p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, wrow, sq, lane);
}

template <int BK, int BQ, int STAGES>
__global__ void __launch_bounds__(BK * 2)
    flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && STAGES >= 2, "tile shape");
  constexpr int NT = BK * 2, NQ = BQ / 8, NO = kD / 8;
  using L = DkvSmem<BK, BQ, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = vstar::smem_u32(smem + L::k_off);
  const uint32_t s_v = vstar::smem_u32(smem + L::v_off);
  const uint32_t s_q = vstar::smem_u32(smem + L::q_off);
  const uint32_t s_do = vstar::smem_u32(smem + L::do_off);
  const uint32_t s_lse = vstar::smem_u32(smem + L::lse_off);
  const uint32_t s_delta = vstar::smem_u32(smem + L::delta_off);
  const float* lse_s = reinterpret_cast<const float*>(smem + L::lse_off);
  const float* delta_s = reinterpret_cast<const float*>(smem + L::delta_off);
  const long long b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int sq = (int)p.sq, skv = (int)p.skv;
  const int kv_len = max(0, min(p.kv_lens[b], skv));
  const int q_off = p.q_offsets[b];
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + b * p.lse_sb + h * p.lse_sh;
  const float* delta = p.delta + b * p.lse_sb + h * p.lse_sh;

  vstar::load_tile_async<kD, BK, NT>(s_k, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0, skv, tid);
  vstar::load_tile_async<kD, BK, NT>(s_v, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0, skv, tid);
  vstar::cp_async_commit();
  // query rows whose kv coordinate is below this key tile never attend to
  // it (the TPU kernel's start_q_block); a tile of keys all at or past
  // kv_len has nothing to do
  const int nqb = (sq + BQ - 1) / BQ;
  int start = k0 - q_off > 0 ? min(nqb, (k0 - q_off) / BQ) : 0;
  if (k0 >= kv_len) start = nqb;
  const int n_tiles = nqb - start;
  auto load_q = [&](int i, int stage) {
    const int q0 = (start + i) * BQ;
    vstar::load_tile_async<kD, BQ, NT>(s_q + stage * BQ * kD * 2, q, p.q_ss, q0, sq, tid);
    vstar::load_tile_async<kD, BQ, NT>(s_do + stage * BQ * kD * 2, dout, p.do_ss, q0, sq, tid);
    for (int c = tid; c < BQ; c += NT) {
      const bool in = q0 + c < sq;
      const long long off = in ? (long long)(q0 + c) * p.lse_ss : 0;
      vstar::cp_async4(s_lse + (stage * BQ + c) * 4, lse + off, in);
      vstar::cp_async4(s_delta + (stage * BQ + c) * 4, delta + off, in);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_q(st, st);
    vstar::cp_async_commit();
  }

  // keys kw0 + g and kw0 + g + 8 of this warp: below kv_len and valid
  const int kw0 = k0 + warp * 16;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    key_ok[r] = key < kv_len && (valid == nullptr || valid[key] != 0);
  }
  const bool warp_live = kw0 < kv_len;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float sl = p.scale * vstar::kLog2e;

  for (int i = 0; i < n_tiles; ++i) {
    vstar::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load_q(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    vstar::cp_async_commit();
    const int stage = i % STAGES, q0 = (start + i) * BQ;
    // no query row of the tile sees a key of this warp
    if (!warp_live || q_off + q0 + BQ - 1 < kw0) continue;
    const uint32_t qst = s_q + stage * BQ * kD * 2;
    const uint32_t dst = s_do + stage * BQ * kD * 2;
    float st[NQ][4], dpt[NQ][4];
    vstar::qk_tile_sa<kD, NQ>(st, s_k, warp * 16, qst, lane);
    vstar::qk_tile_sa<kD, NQ>(dpt, s_v, warp * 16, dst, lane);
    const bool edge = kw0 + 15 > q_off + q0 || q0 + BQ > sq;
    uint32_t pf[NQ / 2][4], dsf[NQ / 2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float nl[2], dl[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = stage * BQ + n * 8 + 2 * t4 + cc;
        nl[cc] = lse_log2(lse_s[c]);
        dl[cc] = delta_s[c];
      }
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = e & 1, r = e >> 1;
        float x = vstar::fast_exp2(st[n][e] * sl - nl[cc]);
        bool ok = key_ok[r];
        if (edge) {
          const int qrow = q0 + n * 8 + 2 * t4 + cc;
          ok = ok && qrow < sq && kw0 + g + 8 * r <= q_off + qrow;
        }
        pr[e] = ok ? x : 0.f;
        ds[e] = pr[e] * (dpt[n][e] - dl[cc]);
      }
      pf[n / 2][(n & 1) * 2] = vstar::pack_bf16(pr[0], pr[1]);
      pf[n / 2][(n & 1) * 2 + 1] = vstar::pack_bf16(pr[2], pr[3]);
      dsf[n / 2][(n & 1) * 2] = vstar::pack_bf16(ds[0], ds[1]);
      dsf[n / 2][(n & 1) * 2 + 1] = vstar::pack_bf16(ds[2], ds[3]);
    }
    vstar::pv_tile<kD, NQ / 2>(dv, pf, dst, lane);
    vstar::pv_tile<kD, NQ / 2>(dk, dsf, qst, lane);
  }
  vstar::cp_async_wait<0>();
  __syncthreads();
  // the warp's own rows of the K and V tiles (nothing else reads them)
  vstar::store_warp_rows<kD>(dk, p.scale, smem + L::k_off, warp * 16,
                             p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, kw0, skv, lane);
  vstar::store_warp_rows<kD>(dv, 1.f, smem + L::v_off, warp * 16,
                             p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, kw0, skv, lane);
}

// Opts a kernel into its dynamic shared memory once per process (the
// attribute outlives the launch), not on every launch.
template <auto Kernel>
cudaError_t prepare(size_t smem) {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

// Launches the dQ kernel at (BQ, BK, STAGES), or with info != nullptr
// reports {registers, local bytes, static smem, dynamic smem, resident
// blocks, threads} instead.
template <int BQ, int BK, int STAGES>
int run_dq(const BwdParams& p, cudaStream_t stream, long long* info) {
  constexpr size_t smem = DqSmem<BQ, BK, STAGES>::bytes;
  constexpr auto kernel = flash_bwd_dq_kernel<BQ, BK, STAGES>;
  cudaError_t err = prepare<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BQ * 2, smem);
    info[0] = a.numRegs;
    info[1] = (long long)a.localSizeBytes;
    info[2] = (long long)a.sharedSizeBytes;
    info[3] = (long long)smem;
    info[4] = blocks;
    info[5] = BQ * 2;
    return (int)err;
  }
  dim3 grid((unsigned)((p.sq + BQ - 1) / BQ), (unsigned)p.h, (unsigned)p.b);
  kernel<<<grid, BQ * 2, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BK, int BQ, int STAGES>
int run_dkv(const BwdParams& p, cudaStream_t stream, long long* info) {
  constexpr size_t smem = DkvSmem<BK, BQ, STAGES>::bytes;
  constexpr auto kernel = flash_bwd_dkv_kernel<BK, BQ, STAGES>;
  cudaError_t err = prepare<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BK * 2, smem);
    info[0] = a.numRegs;
    info[1] = (long long)a.localSizeBytes;
    info[2] = (long long)a.sharedSizeBytes;
    info[3] = (long long)smem;
    info[4] = blocks;
    info[5] = BK * 2;
    return (int)err;
  }
  dim3 grid((unsigned)((p.skv + BK - 1) / BK), (unsigned)p.h, (unsigned)p.b);
  kernel<<<grid, BK * 2, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The shipped tiles: (query rows, key tile, stages) of the dQ kernel and
// (keys, query tile, stages) of the dK/dV kernel.
#define VSTAR_DQ_TILE 64, 64, 2
#define VSTAR_DKV_TILE 64, 64, 2

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
  return run_dq<VSTAR_DQ_TILE>(VSTAR_BWD_PARAMS, static_cast<cudaStream_t>(stream),
                               nullptr);
}

extern "C" int vstar_flash_attention_bwd_dkv(VSTAR_BWD_ARGS) {
  return run_dkv<VSTAR_DKV_TILE>(VSTAR_BWD_PARAMS, static_cast<cudaStream_t>(stream),
                                 nullptr);
}

// Build facts of K7's two kernels (i = 0: dQ, 1: dK/dV), as
// vstar_attention_kernel_info reports them; -1 past the last.
extern "C" int vstar_bwd_kernel_info(int i, const char** name, long long* vals) {
  if (i == 0) {
    *name = "flash_bwd_dq";
    return run_dq<VSTAR_DQ_TILE>(BwdParams{}, nullptr, vals);
  }
  if (i == 1) {
    *name = "flash_bwd_dkv";
    return run_dkv<VSTAR_DKV_TILE>(BwdParams{}, nullptr, vals);
  }
  return -1;
}
