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
// query rows, so they are bound by KV bytes; prefill and the training
// forward (Sq = 384..768) by the 4*Sq*Skv*D operations of each head. The
// kernels read the cache in place through its strides (no transpose, no
// copy) and stop at kv_lens and at the last causal column. Two routes:
//
//   tile  (Sq > 16): vstar::attention_tile (attention_common.cuh), the
//         register-resident FlashAttention-2 tile: one block per (query
//         tile of BQ rows, head, batch row), Q / S / P / O in registers,
//         mma.sync bf16, a cp.async K/V ring. BQ = 64 (4 warps): 128
//         rows (8 warps, one resident block per SM at ~222 registers a
//         thread) measured 3-7 % slower at the training shape and at
//         prefill.
//   split (Sq <= 16, decode and verify chunks): a (B, H) grid would put
//         32 blocks on 132 SMs, each streaming its head's whole cache,
//         with 15 of 16 tile rows padding. Instead each (batch, head)'s
//         keys [0, min(kv_len, last causal column + 1)) are cut into
//         n_splits equal shares of whole 16-key groups (n_splits from the
//         shapes and the SM count on the host, never from kv_lens, so the
//         launch needs no host sync and is capturable in a CUDA graph).
//         A block of 4 warps takes one share, each warp its own 16-key
//         groups through a warp-private cp.async ring; the warps merge in
//         shared memory and the block writes an f32 partial (m, l,
//         unnormalised O) to a workspace. A second kernel merges the
//         partials in split order (no atomics: eager and graph replay are
//         bit-equal) and writes O in bf16 and, when asked, the lse.
//
// For training, the caller may also ask for each row's log-sum-exp (f32
// [B, Sq, H], explicit strides; the TPU forward's second output), which
// the backward (flash_attention_bwd.cu) needs. On the tile route that is
// a separate instantiation (LSE = true), so the serving kernel compiles
// without it.
#include "attention_common.cuh"

namespace {

using vstar::bf16;

constexpr int kD = 128;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kStages = 2;
constexpr int kSplitRows = 16;    // query rows of the split route
constexpr int kSplitWarps = 4;
constexpr int kSplitStages = 2;
constexpr int kGroup = 16;        // keys of a split-route group
static_assert(kSplitWarps * 32 == kD, "the split merge gives a thread per column");

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kv_lens;
  const int* q_offsets;
  const uint8_t* kv_valid;  // [B, Skv] bytes, or nullptr
  float* lse;               // [B, Sq, H] f32, or nullptr
  float* ws_o;              // split route: [B, H, n_splits, Sq, D] f32
  float* ws_ml;             // split route: [B, H, n_splits, Sq, 2] f32
  long long b, sq, skv, h;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long valid_sb;
  long long lse_sb, lse_ss, lse_sh;
  float scale;
};

template <bool LSE>
__global__ void __launch_bounds__(kBQ * 2)
    flash_tile_kernel(const FlashParams p) {
  const long long b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kv_len = max(0, min(p.kv_lens[b], (int)p.skv));
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  vstar::attention_tile<kD, kBQ, kBK, kStages, true, LSE>(
      p.q + b * p.q_sb + h * p.q_sh, p.q_ss, p.k + b * p.k_sb + h * p.k_sh,
      p.k_ss, p.v + b * p.v_sb + h * p.v_sh, p.v_ss,
      p.o + b * p.o_sb + h * p.o_sh, p.o_ss, q0, (int)p.sq, kv_len,
      p.q_offsets[b], valid, p.scale,
      LSE ? p.lse + b * p.lse_sb + h * p.lse_sh : nullptr, p.lse_ss);
}

// Split route shared memory: Q (16 rows), then per warp a ring of
// kSplitStages (K, V) group pairs; after the key loop the ring is reused
// for the warps' (m, l, O) to merge (O rows padded against conflicts).
struct SplitSmem {
  static constexpr size_t q_bytes = (size_t)kSplitRows * kD * 2;
  static constexpr size_t group_bytes = (size_t)kGroup * kD * 2;
  static constexpr size_t warp_bytes = (size_t)kSplitStages * 2 * group_bytes;
  static constexpr int LDO = kD + 8;
  static constexpr size_t merge_o = (size_t)kSplitWarps * kSplitRows * LDO * 4;
  static constexpr size_t merge_bytes = merge_o + (size_t)kSplitWarps * kSplitRows * 2 * 4;
  static constexpr size_t ring_bytes = (size_t)kSplitWarps * warp_bytes;
  static constexpr size_t bytes =
      q_bytes + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes);
};

__global__ void __launch_bounds__(kSplitWarps * 32)
    flash_split_kernel(const FlashParams p) {
  using L = SplitSmem;
  constexpr int NO = kD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const long long b = blockIdx.z, h = blockIdx.y;
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int sq = (int)p.sq;
  const int kv_len = max(0, min(p.kv_lens[b], (int)p.skv));
  const int q_off = p.q_offsets[b];
  // keys any row may see: [0, min(kv_len, last causal column + 1))
  const int range = max(0, min(kv_len, q_off + sq));
  const int groups = (range + kGroup - 1) / kGroup;
  const int per = (groups + n_splits - 1) / n_splits;
  const int g0 = min(split * per, groups), g1 = min(g0 + per, groups);

  const bf16* q = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* k = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* v = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.valid_sb : nullptr;
  const uint32_t s_q = vstar::smem_u32(smem);
  const uint32_t s_ring = s_q + L::q_bytes + warp * L::warp_bytes;

  vstar::load_tile_async<kD, kSplitRows, kSplitWarps * 32>(s_q, q, p.q_ss, 0, sq, tid);
  vstar::cp_async_commit();
  auto load_group = [&](int gi, int st) {
    const uint32_t dst = s_ring + st * 2 * L::group_bytes;
    vstar::load_tile_async<kD, kGroup, 32>(dst, k, p.k_ss, gi * kGroup, range, lane);
    vstar::load_tile_async<kD, kGroup, 32>(dst + L::group_bytes, v, p.v_ss, gi * kGroup, range, lane);
  };
  const int first = g0 + warp;
  if (first < g1) load_group(first, 0);
  vstar::cp_async_commit();
  vstar::cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    vstar::ldmatrix_x4(qf[kk], s_q + vstar::swz<kD>(lane & 15, kk * 2 + (lane >> 4)));

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const float sl = p.scale * vstar::kLog2e;

  int st = 0;
  for (int gi = first; gi < g1; gi += kSplitWarps, st ^= 1) {
    if (gi + kSplitWarps < g1) load_group(gi + kSplitWarps, st ^ 1);
    vstar::cp_async_commit();
    vstar::cp_async_wait<1>();
    __syncwarp();
    const uint32_t kst = s_ring + st * 2 * L::group_bytes;
    float s[2][4];
    vstar::qk_tile<kD, 2>(s, qf, kst, lane);
    const int c0 = gi * kGroup;
    const bool edge = c0 + kGroup > kv_len || valid != nullptr ||
                      c0 + kGroup - 1 > q_off;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl;
        if (edge) {
          const int col = c0 + n * 8 + 2 * t4 + (e & 1);
          bool ok = col < kv_len && col <= q_off + g + (e >> 1) * 8;
          if (valid != nullptr) ok = ok && valid[col] != 0;
          x = ok ? x : -CUDART_INF_F;
        }
        s[n][e] = x;
      }
    uint32_t pf[1][4];
    vstar::softmax_step<2, NO>(s, m, l, oacc, pf);
    vstar::pv_tile<kD, 1>(oacc, pf, kst + L::group_bytes, lane);
    __syncwarp();
  }
  vstar::cp_async_wait<0>();
  __syncthreads();

  // Merge the four warps in warp order, then write this split's partial.
  float* mo = reinterpret_cast<float*>(smem + L::q_bytes);
  float* mml = mo + kSplitWarps * kSplitRows * L::LDO;
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = vstar::quad_sum(l[r]);
  if (t4 == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mml[(warp * kSplitRows + g + 8 * r) * 2] = m[r];
      mml[(warp * kSplitRows + g + 8 * r) * 2 + 1] = l[r];
    }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(mo + (warp * kSplitRows + g + 8 * r) * L::LDO +
                                 n * 8 + 2 * t4) =
          make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
  __syncthreads();
  const long long part = ((b * p.h + h) * n_splits + split) * sq;
  for (int r = 0; r < sq; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, mml[(w * kSplitRows + r) * 2]);
    float acc = 0.f, lsum = 0.f;
    if (mx != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float wt = vstar::fast_exp2(mml[(w * kSplitRows + r) * 2] - mx);
        lsum += wt * mml[(w * kSplitRows + r) * 2 + 1];
        acc += wt * mo[(w * kSplitRows + r) * L::LDO + tid];
      }
    }
    p.ws_o[(part + r) * kD + tid] = acc;
    if (tid == 0) {
      p.ws_ml[(part + r) * 2] = mx;
      p.ws_ml[(part + r) * 2 + 1] = lsum;
    }
  }
}

// Merges the n_splits partials of each (row, head, batch row) in split
// order: O = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s.
template <bool LSE>
__global__ void __launch_bounds__(kD)
    flash_combine_kernel(const FlashParams p, int n_splits) {
  const long long b = blockIdx.y, h = blockIdx.x;
  const int d = threadIdx.x, sq = (int)p.sq;
  const long long part0 = (b * p.h + h) * n_splits * sq;
  for (int r = 0; r < sq; ++r) {
    float mx = -CUDART_INF_F;
    for (int s = 0; s < n_splits; ++s)
      mx = fmaxf(mx, p.ws_ml[(part0 + (long long)s * sq + r) * 2]);
    float acc = 0.f, lsum = 0.f;
    if (mx != -CUDART_INF_F) {
      for (int s = 0; s < n_splits; ++s) {
        const long long i = part0 + (long long)s * sq + r;
        const float ms = p.ws_ml[i * 2];
        if (ms == -CUDART_INF_F) continue;
        const float wt = exp2f(ms - mx);
        lsum += wt * p.ws_ml[i * 2 + 1];
        acc += wt * p.ws_o[i * kD + d];
      }
    }
    p.o[b * p.o_sb + r * p.o_ss + h * p.o_sh + d] =
        __float2bfloat16(lsum > 0.f ? acc / lsum : 0.f);
    if (LSE && d == 0)
      p.lse[b * p.lse_sb + r * p.lse_ss + h * p.lse_sh] =
          lsum > 0.f ? (mx + log2f(lsum)) * vstar::kLn2 : -CUDART_INF_F;
  }
}

constexpr size_t kTileSmem = vstar::TileSmem<kD, kBQ, kBK, kStages>::bytes;

// Opts a kernel into its dynamic shared memory once per process (the
// attribute outlives the launch), not on every launch.
template <auto Kernel>
cudaError_t prepare(size_t smem) {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return err;
}

template <bool LSE>
int launch_tile(const FlashParams& p, cudaStream_t stream) {
  cudaError_t err = prepare<&flash_tile_kernel<LSE>>(kTileSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((p.sq + kBQ - 1) / kBQ), (unsigned)p.h, (unsigned)p.b);
  flash_tile_kernel<LSE><<<grid, kBQ * 2, kTileSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool LSE>
int launch_split(const FlashParams& p, int n_splits, cudaStream_t stream) {
  cudaError_t err = prepare<&flash_split_kernel>(SplitSmem::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_splits, (unsigned)p.h, (unsigned)p.b);
  flash_split_kernel<<<grid, kSplitWarps * 32, SplitSmem::bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_combine_kernel<LSE><<<dim3((unsigned)p.h, (unsigned)p.b), kD, 0, stream>>>(p, n_splits);
  return (int)cudaGetLastError();
}

struct KernelInfo {
  const char* name;
  const void* fn;
  int threads;
  size_t smem;
  cudaError_t (*prep)(size_t);
};

cudaError_t no_prep(size_t) { return cudaSuccess; }

const KernelInfo kKernels[] = {
    {"flash_tile", (const void*)flash_tile_kernel<false>, kBQ * 2, kTileSmem,
     prepare<&flash_tile_kernel<false>>},
    {"flash_tile<lse>", (const void*)flash_tile_kernel<true>, kBQ * 2, kTileSmem,
     prepare<&flash_tile_kernel<true>>},
    {"flash_split", (const void*)flash_split_kernel, kSplitWarps * 32, SplitSmem::bytes,
     prepare<&flash_split_kernel>},
    {"flash_combine", (const void*)flash_combine_kernel<false>, kD, 0, no_prep},
    {"flash_combine<lse>", (const void*)flash_combine_kernel<true>, kD, 0, no_prep},
};
constexpr int kNumKernels = sizeof(kKernels) / sizeof(kKernels[0]);

}  // namespace

// Defined in flash_attention_bwd.cu and tower_attention.cu (same library).
extern "C" int vstar_bwd_kernel_info(int i, const char** name, long long* vals);
extern "C" int vstar_tower_kernel_info(int i, const char** name, long long* vals);
constexpr int kNumBwdKernels = 2;   // K7's dQ and dK/dV kernels

// Build facts of the i-th attention kernel instantiation (K1's, then
// K7's, then K2's): vals = {registers per thread, local (spill) bytes per
// thread, static shared bytes, dynamic shared bytes, resident blocks per
// SM, threads per block}. Returns 0, -1 past the last one, or a CUDA
// error.
extern "C" int vstar_attention_kernel_info(int i, const char** name, long long* vals) {
  if (i >= kNumKernels + kNumBwdKernels)
    return vstar_tower_kernel_info(i - kNumKernels - kNumBwdKernels, name, vals);
  if (i >= kNumKernels) return vstar_bwd_kernel_info(i - kNumKernels, name, vals);
  if (i < 0) return -1;
  const KernelInfo& kinfo = kKernels[i];
  cudaError_t err = kinfo.prep(kinfo.smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kinfo.fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kinfo.fn, kinfo.threads, kinfo.smem);
  if (err != cudaSuccess) return (int)err;
  *name = kinfo.name;
  vals[0] = attr.numRegs;
  vals[1] = (long long)attr.localSizeBytes;
  vals[2] = (long long)attr.sharedSizeBytes;
  vals[3] = (long long)kinfo.smem;
  vals[4] = blocks;
  vals[5] = kinfo.threads;
  return 0;
}

// n_splits > 0 takes the split route (ws_o, ws_ml: the workspaces, sized
// by the caller), 0 the tile route.
extern "C" int vstar_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kv_lens,
    const void* q_offsets, const void* kv_valid, void* lse, void* ws_o,
    void* ws_ml, long long n_splits, long long b, long long sq, long long skv,
    long long h, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long valid_sb, long long lse_sb, long long lse_ss, long long lse_sh,
    float scale, void* stream) {
  FlashParams p{static_cast<const bf16*>(q),
                static_cast<const bf16*>(k),
                static_cast<const bf16*>(v),
                static_cast<bf16*>(o),
                static_cast<const int*>(kv_lens),
                static_cast<const int*>(q_offsets),
                static_cast<const uint8_t*>(kv_valid),
                static_cast<float*>(lse),
                static_cast<float*>(ws_o),
                static_cast<float*>(ws_ml),
                b, sq, skv, h,
                q_sb, q_ss, q_sh,
                k_sb, k_ss, k_sh,
                v_sb, v_ss, v_sh,
                o_sb, o_ss, o_sh,
                valid_sb,
                lse_sb, lse_ss, lse_sh,
                scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits > 0) {
    if (sq > kSplitRows) return (int)cudaErrorInvalidValue;
    return lse != nullptr ? launch_split<true>(p, (int)n_splits, s)
                          : launch_split<false>(p, (int)n_splits, s);
  }
  return lse != nullptr ? launch_tile<true>(p, s) : launch_tile<false>(p, s);
}

extern "C" const char* vstar_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
