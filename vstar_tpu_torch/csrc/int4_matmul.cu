// K5 (W4A16) and K6 (W4A8): group-wise int4 weight matmuls on sm_90a.
//
// Replaces vstar_tpu/kernels/int4_matmul.py:_kernel (K5) and
// :_w4a8_kernel (K6). Weight format (nn/quant.quantize_weight_int4):
// q4 uint8 [IN/2, OUT], packed row p holds input 2p in its low nibble and
// 2p+1 in its high nibble, both two's-complement signed 4-bit; s4 f32
// [IN/group, OUT], one scale per (group of `group` inputs, column).
//
// K5  y[R, OUT] (bf16) = x[R, IN] (bf16) @ (nib * s4)
//   R <= 16 (decode, verify, lm_head rows): bound by the packed bytes
//   (4096 x 11008 is 22.5 MB of nibbles plus 0.2 MB of scales, ~7.1 us at
//   3.35 TB/s). Tensor-core decode rows (decode_rows.cuh, shared with K3):
//   nibbles unpacked by bit operations straight into bf16 mma operands, a
//   cp.async ring per warp, split-K added in order across a thread-block
//   cluster; one launch.
//   R > 16 (prefill at 384-768 rows, option chunks): compute-bound tiles
//   (below): a cp.async ring of x, nibbles and scales, the weight tile
//   dequantized once per block (nib * scale rounded to bf16 as the TPU
//   kernel does) into shared memory, mma.sync on ldmatrix fragments, one
//   barrier per k-tile; one launch.
// K6  y[R, OUT] (f32) = xq[R, IN] (int8) @ nib, with each group's exact
//   int32 dot scaled by s4 / 16 (the activation scale is the caller's), for
//   R <= 16; bound by the packed bytes, as K5's decode rows. The decode rows
//   in their W4A8 format (decode_rows.cuh): the packed bytes become 16 *
//   nibble int8 mma operands by two masks (high nibble b & 0xF0, low
//   nibble (b << 4) & 0xF0), after a 4 x 4 byte transpose that puts four
//   packed rows of one column into one register, and m16n8k32 s8 mma.sync
//   sums each group exactly in int32; one launch, no workspace. Its work
//   does not grow with R up to 8 rows (one n-tile) and doubles at 16.
// K6's qdot (qdot4_w4a8 on a CUDA tensor) is two launches: the per-row
//   activation quantization below (one block a row: the row's largest
//   |x|, sx = max(amax, 1e-8) / 127 by IEEE division, xq = clamp(rint(x /
//   sx), -127, 127), the bits of quantize_activations), then K6 launched
//   dependent on it (programmatic dependent launch: K6's blocks start and
//   copy their first weight stages while the quantization runs, and wait
//   for it before they read x), whose store multiplies by sx and writes
//   x's type. (With 128-thread blocks of 168 registers, K6's wave filled
//   the register file at 16 rows, and the quantization's blocks pushed
//   part of it into a second wave; the 64-thread blocks are bound by
//   shared memory, which the quantization does not take.) The
//   alternative, each K6 block quantizing its rows itself
//   (kFmtW4A8Q: the rows' maxima read whole by every block, an IEEE
//   division per input at each B fragment), measured 1.5-2.7x slower at R
//   = 1 and 16 (kernel_probe.py --w4a8-quant; PERF.md).
//
// Both take any OUT, including the ragged 32003-wide lm_head: columns past
// OUT are masked.
#include "decode_rows.cuh"

namespace {

// The shipped decode-row shape of K5 (decode_rows.cuh): packed rows of a
// ring stage, ring stages, warps side by side along the columns (WC) and
// k-splits (WK) per block, L2 prefetch. It won a sweep of those knobs,
// cluster sizes and L2 prefetch hints (vstar_tpu_torch/scripts/
// kernel_probe.py --k5-shapes; PERF.md).
//
// What bounds it (H100, measured at R = 1 on 4096x11008, 0.019 ms): about
// half is fixed cost: ~3.5 us for a launch of blocks that do nothing,
// ~4 us for the ring's x and scale copies and waits, ~2 us for the
// cluster reduction. The weight stream adds ~6 us (22.5 MB at about the
// 3.35 TB/s peak) and the products ~3 us beyond it.
#define VSTAR_K5_DECODE kFmtInt4, 32, 3, 1, 4, 0
// K6's decode-row shape: 64 packed rows (one group) a stage, 3 stages,
// two warps side by side along 256-column strips, one k-split a block;
// it won kernel_probe.py --k6-shapes at one row on the three 7B shapes
// (PERF.md), over K5's shape among others.
#define VSTAR_K6_DECODE kFmtW4A8, 64, 3, 2, 1, 0

// ---------------------------------------------------------------------------
// K5, R > 16: pipelined tensor-core tiles with in-block dequantization
// ---------------------------------------------------------------------------
//
// What bounds it: the products. R = 384 on 4096x11008 is 34.6 GFLOP, 35 us
// at the 989 TFLOP/s bf16 peak, against 22.5 MB of nibbles (7 us). The
// arithmetic is the TPU kernel's: each weight nib * s4 in f32, rounded to
// bf16, then bf16 x bf16 products summed in f32.
//
// A block of 8 warps (2 along M x 4 along N) owns a BM x BN output tile
// (and, split across a thread-block cluster of KS blocks, 1 / KS of the
// inputs) and walks the inputs in k-tiles of 64:
//   ring     a STAGES-deep cp.async ring (16-byte copies) of the x tile
//            [BM, 64] bf16 (swizzled rows, as K1's Q), the packed nibbles
//            [32, BN] and the BN scales of the k-tile's group;
//   dequant  once per block and k-tile: each thread turns 8 columns of a
//            few packed rows into two rows of the bf16 weight tile [64, BN]
//            (nibble exact as f32 2^23 + (n ^ 8) - (2^23 + 8) by one byte
//            permute, times the f32 scale, one cvt.rn.bf16x2.f32 per pair),
//            stored as 16-byte words into a swizzled, double-buffered tile;
//   mma      mma.sync.m16n8k16 on ldmatrix fragments: x as A, the weight
//            tile through ldmatrix.trans as B, f32 accumulators in
//            registers (a warp tile of BM / 2 x BN / 4).
// One block barrier per k-tile: at iteration i the ring holds k-tile i + 1
// before the barrier, the warps run the products of k-tile i on weight
// buffer i % 2 and then dequantize k-tile i + 1 into the other buffer,
// while the copies of k-tile i + STAGES - 1 are in flight.
// Epilogue: the bf16 tile through shared memory and 16-byte row stores;
// with KS > 1 the f32 partials of the cluster's blocks are added in rank
// order through distributed shared memory (no workspace, no atomics).
// The tile shape, ring depth and KS were swept with kernel_probe.py
// --k5-tiles (int4_probe.cu); the host's plan picks the shape and KS.
// Ragged OUT and unaligned operands copy the aligned 16-byte chunks that
// cover each packed row and funnel-shift, as the decode rows do.

constexpr int kTk = 64;             // inputs of a k-tile (32 packed rows)
constexpr int kTileThreads = 256;   // 8 warps: 2 along M x 4 along N

template <int BM, int BN, int STAGES, bool ALIGNED>
struct TileLayout {
  static constexpr int p_row = ALIGNED ? BN : BN + 16;   // ring bytes of a packed row
  static constexpr size_t x_bytes = (size_t)BM * kTk * 2;
  static constexpr size_t p_bytes = (size_t)(kTk / 2) * p_row;
  static constexpr size_t s_bytes = (size_t)BN * 4;
  static constexpr size_t stage = x_bytes + p_bytes + s_bytes;
  static constexpr size_t ring = STAGES * stage;
  static constexpr size_t w_bytes = (size_t)kTk * BN * 2;    // one bf16 weight tile
  static constexpr int part_row = BN + 4;                    // floats of a partial row
  static constexpr size_t main_bytes = ring + 2 * w_bytes;
  static constexpr size_t part_bytes = (size_t)BM * part_row * 4;
  static constexpr size_t bytes = main_bytes > part_bytes ? main_bytes : part_bytes;
  static_assert(BM % 32 == 0 && BN % 64 == 0 && STAGES >= 3, "tile shape");
};

// Nibble k of u, where u holds four nibbles n ^ 8 in the low bits of its
// bytes, as the f32 value n (magic: 0x4B000000, as for byte_f32).
__device__ __forceinline__ float nibble_f32(uint32_t u, int k, uint32_t magic) {
  return __uint_as_float(__byte_perm(u, magic, 0x7440 | k)) - 8388616.f;
}

// (v & 0x0F0F0F0F) ^ 0x08080808
__device__ __forceinline__ uint32_t nibbles_xor8(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(r) : "r"(v), "r"(0x0F0F0F0Fu), "r"(0x08080808u));
  return r;
}

// PF: 0 ships; kernel_probe.py --k5-tiles's timing breakdown adds 2 (no
// dequantization), 4 (no products) or 8 (no global copies), which give
// wrong results.
template <int BM, int BN, int STAGES, bool ALIGNED, int KS, int PF>
__global__ void __launch_bounds__(kTileThreads)
    int4_tile_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q4,
                     const float* __restrict__ s4, bf16* __restrict__ y, int rows,
                     long long in, long long out, int group) {
  using L = TileLayout<BM, BN, STAGES, ALIGNED>;
  constexpr int MT = BM / 32, NT = BN / 32;            // m16 / n8 tiles of a warp
  constexpr int CG = BN / 8, PR = kTileThreads / CG;   // 8-column groups; rows a pass
  constexpr int XI = BM * 8 / kTileThreads, QI = BN / 128;   // copies a thread issues
  extern __shared__ __align__(128) unsigned char tile_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t4 = lane & 3;
  int rank = 0;
  if constexpr (KS > 1) rank = (int)cg::this_cluster().block_rank();
  const long long n0 = (long long)(blockIdx.x / KS) * BN, m0 = (long long)blockIdx.y * BM;
  const int nk_all = (int)(in / kTk), per = (nk_all + KS - 1) / KS;
  const int kt0 = min(nk_all, rank * per), nk = min(nk_all, kt0 + per) - kt0;
  const uint32_t base = vstar::smem_u32(tile_smem);
  const uint32_t wd0 = base + (uint32_t)L::ring;
  const uint8_t* q4_end = q4 + in / 2 * out;

  // The copies' addresses, worked out once: x chunk tid % 8 of tile rows
  // tid / 8 + 32 it; packed chunk tid % (BN / 16) of packed rows
  // tid / (BN / 16) + (4096 / BN) it (aligned); a k-tile adds its offset.
  const int xr0 = tid >> 3, xc = tid & 7;
  const bf16* x_src = x + (m0 + xr0) * in + 8 * xc;
  const uint32_t x_dst = vstar::swz<kTk>(xr0, xc);
  bool x_ok[XI];
#pragma unroll
  for (int it = 0; it < XI; ++it) x_ok[it] = m0 + xr0 + 32 * it < rows;
  const int qr0 = tid / (BN / 16), qc = tid % (BN / 16);
  const bool q_ok = n0 + 16 * qc < out;
  const uint8_t* q_src = q4 + qr0 * out + n0 + 16 * qc;
  const float* s_src = s4 + n0 + 4 * tid;
  const bool s_ok = tid < BN / 4 && n0 + 4 * tid < out;

  auto load_stage = [&](int i, int slot) {
    if constexpr ((PF & 8) != 0) return;
    const uint32_t xd = base + slot * (uint32_t)L::stage;
    const uint32_t pd = xd + (uint32_t)L::x_bytes, sd = pd + (uint32_t)L::p_bytes;
    const long long k0 = (long long)(kt0 + i) * kTk, p0 = k0 / 2;
#pragma unroll
    for (int it = 0; it < XI; ++it)
      vstar::cp_async16(xd + x_dst + it * 32 * kTk * 2,
                        x_ok[it] ? x_src + 32 * it * in + k0 : x, x_ok[it]);
    if constexpr (ALIGNED) {
      const uint8_t* src = q_src + p0 * out;
#pragma unroll
      for (int it = 0; it < QI; ++it)   // 32 rows of BN / 16 chunks
        vstar::cp_async16(pd + (qr0 + 4096 / BN * it) * L::p_row + 16 * qc,
                          q_ok ? src + 4096 / BN * it * out : q4, q_ok);
      if (tid < BN / 4)
        vstar::cp_async16(sd + 16 * tid, s_ok ? s_src + (k0 / group) * out : s4, s_ok);
    } else {
      for (int idx = tid; idx < 32 * (BN / 16 + 1); idx += kTileThreads) {
        const int r = idx / (BN / 16 + 1), c = idx % (BN / 16 + 1);
        const uintptr_t a =
            (reinterpret_cast<uintptr_t>(q4 + (p0 + r) * out + n0) & ~(uintptr_t)15) + 16 * c;
        const bool ok = a + 16 > reinterpret_cast<uintptr_t>(q4) &&
                        a < reinterpret_cast<uintptr_t>(q4_end);
        vstar::cp_async16(pd + r * L::p_row + 16 * c,
                          ok ? reinterpret_cast<const void*>(a) : q4, ok);
      }
      const float* src = s4 + (k0 / group) * out + n0;
      for (int c = tid; c < BN; c += kTileThreads) {
        const bool ok = n0 + c < out;
        vstar::cp_async4(sd + 4 * c, ok ? src + c : s4, ok);
      }
    }
  };

  // this thread's share of the dequantization: 8-column group cg8 of the
  // packed rows pr0, pr0 + PR, ... (rows 2 pr and 2 pr + 1 of the tile)
  const int cg8 = tid % CG, pr0 = tid / CG;
  const uint32_t magic = magic_2p23();
  auto dequant = [&](int i, int slot, int buf) {
    if constexpr ((PF & 2) != 0) return;
    const unsigned char* ps = tile_smem + slot * L::stage + L::x_bytes;
    const float4* sc = reinterpret_cast<const float4*>(ps + L::p_bytes) + 2 * cg8;
    const float4 sa = sc[0], sb = sc[1];
    const float s8[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    const long long p0 = (long long)(kt0 + i) * (kTk / 2);
    const uint32_t wd = wd0 + buf * (uint32_t)L::w_bytes;
#pragma unroll
    for (int j = 0; j < 32 / PR; ++j) {
      const int pr = pr0 + PR * j;
      uint32_t w[2];
      if constexpr (ALIGNED) {
        const uint2 v = *reinterpret_cast<const uint2*>(ps + pr * L::p_row + 8 * cg8);
        w[0] = v.x; w[1] = v.y;
      } else {
        const int sh = (int)(reinterpret_cast<uintptr_t>(q4 + (p0 + pr) * out + n0) & 15);
        const uint32_t* wp =
            reinterpret_cast<const uint32_t*>(ps + pr * L::p_row) + (sh >> 2) + 2 * cg8;
        const uint32_t v0 = wp[0], v1 = wp[1], v2 = wp[2];
        w[0] = __funnelshift_r(v0, v1, 8 * (sh & 3));
        w[1] = __funnelshift_r(v1, v2, 8 * (sh & 3));
      }
      uint32_t o[2][4];   // rows 2 pr (low nibbles) and 2 pr + 1 (high)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo = nibbles_xor8(w[h]), hi = nibbles_xor8(w[h] >> 4);
#pragma unroll
        for (int k = 0; k < 4; k += 2) {
          o[0][2 * h + k / 2] = vstar::pack_bf16(nibble_f32(lo, k, magic) * s8[4 * h + k],
                                                 nibble_f32(lo, k + 1, magic) * s8[4 * h + k + 1]);
          o[1][2 * h + k / 2] = vstar::pack_bf16(nibble_f32(hi, k, magic) * s8[4 * h + k],
                                                 nibble_f32(hi, k + 1, magic) * s8[4 * h + k + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(wd + vstar::swz<BN>(2 * pr + r, cg8)), "r"(o[r][0]), "r"(o[r][1]),
                        "r"(o[r][2]), "r"(o[r][3]) : "memory");
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto mma_tile = [&](int slot, int buf) {
    if constexpr ((PF & 4) != 0) return;
    const uint32_t xs = base + slot * (uint32_t)L::stage;
    const uint32_t wd = wd0 + buf * (uint32_t)L::w_bytes;
#pragma unroll
    for (int kk = 0; kk < kTk / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        vstar::ldmatrix_x4(a[mt], xs + vstar::swz<kTk>(wm * (BM / 2) + 16 * mt + (lane & 15),
                                                       2 * kk + (lane >> 4)));
#pragma unroll
      for (int nb = 0; nb < NT / 2; ++nb) {
        uint32_t b[4];
        const int key = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        vstar::ldmatrix_x4_trans(b, wd + vstar::swz<BN>(key, wn * NT + 2 * nb + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          vstar::mma_bf16(acc[mt][2 * nb], a[mt], b[0], b[1]);
          vstar::mma_bf16(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
      }
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    vstar::cp_async_commit();
  }
  if (nk > 0) {
    vstar::cp_async_wait<STAGES - 2>();
    __syncthreads();
    dequant(0, 0, 0);
  }
  for (int i = 0; i < nk; ++i) {
    // k-tile i + 1 has landed (this thread's copies), and after the
    // barrier everybody's copies, weight buffer i % 2, and the end of
    // iteration i - 1 (its ring slot and weight buffer are free)
    vstar::cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (i + STAGES - 1 < nk) load_stage(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    vstar::cp_async_commit();
    mma_tile(i % STAGES, i & 1);
    if (i + 1 < nk) dequant(i + 1, (i + 1) % STAGES, (i + 1) & 1);
  }
  vstar::cp_async_wait<0>();
  __syncthreads();   // the ring and weight tiles are free for the epilogue

  if constexpr (KS == 1) {
    // the bf16 tile [BM, BN] in swizzled rows, then 16-byte row stores
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(
              tile_smem + vstar::swz<BN>(wm * (BM / 2) + 16 * mt + g + 8 * r, wn * NT + nt) +
              4 * t4) = vstar::pack_bf16(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
    __syncthreads();
    for (int idx = tid; idx < BM * CG; idx += kTileThreads) {
      const int r = idx / CG, c = idx % CG;
      const long long row = m0 + r, col = n0 + 8 * c;
      if (row >= rows) continue;
      const unsigned char* src = tile_smem + vstar::swz<BN>(r, c);
      if constexpr (ALIGNED) {
        if (col < out)
          *reinterpret_cast<uint4*>(y + row * out + col) = *reinterpret_cast<const uint4*>(src);
      } else {
        const bf16* v = reinterpret_cast<const bf16*>(src);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (col + j < out) y[row * out + col + j] = v[j];
      }
    }
  } else {
    // the f32 partials of the cluster's k-splits, added in rank order
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(tile_smem);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(part + (wm * (BM / 2) + 16 * mt + g + 8 * r) * L::part_row +
                                     wn * (BN / 4) + 8 * nt + 2 * t4) =
              make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
    cluster.sync();
    constexpr int RPB = BM / KS;   // tile rows each block writes
    for (int idx = tid; idx < RPB * BN; idx += kTileThreads) {
      const int r = rank * RPB + idx / BN, c = idx % BN;
      float v[KS];
#pragma unroll
      for (int blk = 0; blk < KS; ++blk)
        v[blk] = cluster.map_shared_rank(part, blk)[r * L::part_row + c];
      float total = 0.f;
#pragma unroll
      for (int blk = 0; blk < KS; ++blk) total += v[blk];
      if (m0 + r < rows && n0 + c < out) y[(m0 + r) * out + n0 + c] = __float2bfloat16(total);
    }
    cluster.sync();   // no block leaves while its partials are read
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// K5 at R > 16: tiles of BM x BN, KS blocks (a cluster) per tile along the
// inputs; group % 64 == 0; PF as for int4_tile_kernel.
template <int BM, int BN, int STAGES, bool ALIGNED, int KS, int PF = 0>
int launch_k5_tiles(const bf16* x, const uint8_t* q4, const float* s4, bf16* y, int rows,
                    long long in, long long out, int group, cudaStream_t st) {
  using L = TileLayout<BM, BN, STAGES, ALIGNED>;
  constexpr auto kernel = int4_tile_kernel<BM, BN, STAGES, ALIGNED, KS, PF>;
  if (group % kTk || in % group) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<kernel>(L::bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((out + BN - 1) / BN * KS), (unsigned)((rows + BM - 1) / BM));
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)KS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = KS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, q4, s4, y, rows, in, out, group);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BM, int BN, int STAGES, bool ALIGNED, int KS, int PF = 0>
int info_k5_tiles(long long* vals) {
  return kernel_facts<int4_tile_kernel<BM, BN, STAGES, ALIGNED, KS, PF>>(
      TileLayout<BM, BN, STAGES, ALIGNED>::bytes, kTileThreads, vals);
}

// The shipped tile shapes (index `tile` of the host's plan, int4_matmul.py
// TILE_SHAPES) and k-splits: launches one, or with vals != nullptr reports
// its build facts.
#define VSTAR_K5_TILE_STAGES 3
int run_k5_tiles(int tile, int ks, bool aligned, long long* vals, const bf16* x,
                 const uint8_t* q4, const float* s4, bf16* y, int rows, long long in,
                 long long out, int group, cudaStream_t st) {
#define VSTAR_TILE(BM, BN, KS)                                                          \
  if (aligned)                                                                          \
    return vals ? info_k5_tiles<BM, BN, VSTAR_K5_TILE_STAGES, true, KS>(vals)           \
                : launch_k5_tiles<BM, BN, VSTAR_K5_TILE_STAGES, true, KS>(              \
                      x, q4, s4, y, rows, in, out, group, st);                          \
  return vals ? info_k5_tiles<BM, BN, VSTAR_K5_TILE_STAGES, false, KS>(vals)            \
              : launch_k5_tiles<BM, BN, VSTAR_K5_TILE_STAGES, false, KS>(x, q4, s4, y, rows, \
                                                                         in, out, group, st)
#define VSTAR_TILE_KS(BM, BN) \
  switch (ks) {               \
    case 1: VSTAR_TILE(BM, BN, 1); \
    case 2: VSTAR_TILE(BM, BN, 2); \
    case 4: VSTAR_TILE(BM, BN, 4); \
  }                           \
  break
  switch (tile) {
    case 0: VSTAR_TILE_KS(64, 128);
    case 1: VSTAR_TILE_KS(128, 256);
  }
#undef VSTAR_TILE_KS
#undef VSTAR_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Blocks of K5's decode-row kernel (rows <= 16) that one SM holds, into
// *blocks; `aligned` as for vstar_int4_matmul.
extern "C" int vstar_int4_decode_occupancy(long long rows, long long aligned, void* blocks) {
  long long vals[6];
  const int err = run_decode<VSTAR_K5_DECODE>(true, (int)rows, aligned != 0, vals, nullptr,
                                              nullptr, nullptr, nullptr, 0, 0, 0, 0, 0,
                                              nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Blocks of K5's tile `tile` with `ks` k-splits that one SM holds.
extern "C" int vstar_int4_tile_occupancy(long long tile, long long ks, long long aligned,
                                         void* blocks) {
  long long vals[6];
  const int err = run_k5_tiles((int)tile, (int)ks, aligned != 0, vals, nullptr, nullptr,
                               nullptr, nullptr, 0, 0, 0, 0, nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Build facts of K5's i-th instantiation: the decode rows (rows 8 / 16,
// aligned / ragged), then the shipped tiles (aligned, one k-split), as
// vstar_attention_kernel_info reports them; -1 past the last.
extern "C" int vstar_int4_kernel_info(int i, const char** name, long long* vals) {
  static const char* names[] = {"int4_decode<8, aligned>", "int4_decode<16, aligned>",
                                "int4_decode<8, ragged>", "int4_decode<16, ragged>",
                                "int4_tile<64x128, aligned>", "int4_tile<128x256, aligned>",
                                "int4_tile<64x128, ragged>", "int4_tile<128x256, ragged>"};
  if (i < 0 || i > 7) return -1;
  *name = names[i];
  if (i < 4)
    return run_decode<VSTAR_K5_DECODE>(true, i % 2 ? 16 : 8, i < 2, vals, nullptr, nullptr,
                                       nullptr, nullptr, 0, 0, 0, 0, 0, nullptr);
  return run_k5_tiles(i % 2, 1, i < 6, vals, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0,
                      nullptr);
}

// K5: y [rows, out] bf16 = x [rows, in] bf16 @ dequant(q4 [in/2, out],
// s4 [in/group, out]); contiguous operands, x 16-byte aligned, group % 64
// == 0. rows <= 16 takes the tensor-core decode rows (`cluster` 1..8
// blocks per 128-column strip), rows > 16 the tensor-core tiles (shape
// `tile`, `cluster` k-splits per tile: 1, 2 or 4). aligned: out % 16 ==
// 0 and q4, s4 16-byte aligned.
extern "C" int vstar_int4_matmul(const void* x, const void* q4, const void* s4, void* y,
                                 long long rows, long long in, long long out,
                                 long long group, long long cluster, long long aligned,
                                 long long tile, void* stream) {
  if (group < 64 || group % 64 || in % group || rows < 1) return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const bf16*>(x);
  auto* qb = static_cast<const uint8_t*>(q4);
  auto* sf = static_cast<const float*>(s4);
  auto* yb = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (rows > vstar::kMaxRows)
    return run_k5_tiles((int)tile, (int)cluster, aligned != 0, nullptr, xb, qb, sf, yb,
                        (int)rows, in, out, (int)group, st);
  return run_decode<VSTAR_K5_DECODE>(false, (int)rows, aligned != 0, nullptr, xb, qb, sf, yb,
                                     in, out, in, (int)group, (int)cluster, st);
}


// ---------------------------------------------------------------------------
// K6: the W4A8 decode rows, and the row quantization of its qdot
// ---------------------------------------------------------------------------

namespace {

constexpr int kQuantThreads = 256;

// One block per row r of x [rows, in] (bf16, or f32 with T = float; in %
// 8 == 0, 16-byte aligned): sx[r] = max(max |x[r]|, 1e-8) / 127 and xq[r]
// = clamp(rint(x[r] / sx[r]), -127, 127), quantize_activations' bits.
// With amax not null the row's max |value| is amax[r] (a rank holding part
// of each row: the max over its group), and the kernel reads x once. It
// lets the launch dependent on it (K6) start at once.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    w4a8_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ sx, const float* __restrict__ amax,
                         long long in) {
  constexpr int EV = 16 / sizeof(T);   // values a 16-byte load
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float wmax[kQuantThreads / 32];
  const T* xr = x + blockIdx.x * in;
  auto value = [](const uint4& v, int e) -> float {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (EV == 8)
      return __uint_as_float(e & 1 ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
    else
      return __uint_as_float(w[e]);
  };
  float m = 0.f;
  if (amax != nullptr) {
    m = __ldg(amax + blockIdx.x);
  } else {
    for (long long k = EV * threadIdx.x; k < in; k += EV * kQuantThreads) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + k));
#pragma unroll
      for (int e = 0; e < EV; ++e) m = fmaxf(m, fabsf(value(v, e)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    m = 0.f;
#pragma unroll
    for (int w = 0; w < kQuantThreads / 32; ++w) m = fmaxf(m, wmax[w]);
  }
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* qr = xq + blockIdx.x * in;
  for (long long k = EV * threadIdx.x; k < in; k += EV * kQuantThreads) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + k));
    uint32_t out[EV / 4];
#pragma unroll
    for (int e = 0; e < EV; e += 4)
      out[e / 4] = pack_s8(quant_s8(value(v, e), s), quant_s8(value(v, e + 1), s),
                           quant_s8(value(v, e + 2), s), quant_s8(value(v, e + 3), s));
    if constexpr (EV == 8)
      *reinterpret_cast<uint2*>(qr + k) = make_uint2(out[0], out[1]);
    else
      *reinterpret_cast<uint32_t*>(qr + k) = out[0];
  }
}

}  // namespace

// Blocks of K6's decode-row kernel (rows <= 16) that one SM holds, into
// *blocks; `aligned` as for vstar_int4_w4a8.
extern "C" int vstar_w4a8_decode_occupancy(long long rows, long long aligned, void* blocks) {
  long long vals[6];
  const int err = run_w4a8<VSTAR_K6_DECODE>(true, (int)rows, aligned != 0, vals, nullptr,
                                            nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0,
                                            0, false, nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Build facts of K6's i-th instantiation (rows 8 / 16, aligned / ragged);
// -1 past the last.
extern "C" int vstar_w4a8_kernel_info(int i, const char** name, long long* vals) {
  static const char* names[] = {"w4a8_decode<8, aligned>", "w4a8_decode<16, aligned>",
                                "w4a8_decode<8, ragged>", "w4a8_decode<16, ragged>"};
  if (i < 0 || i > 3) return -1;
  *name = names[i];
  return run_w4a8<VSTAR_K6_DECODE>(true, i % 2 ? 16 : 8, i < 2, vals, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, false, nullptr);
}

// K6: y [rows, out] = xq [rows, in] int8 @ nib(q4 [in/2, out]) with each
// group's int32 dot times s4 [in/group, out] / 16; then times sx [rows]
// when sx is not null; y f32 (y_f32) or bf16. rows <= 16, group % 64 ==
// 0, contiguous operands, xq 16-byte aligned with in % 16 == 0; `cluster`
// (1..16) blocks per 256-column strip; aligned: out % 16 == 0 and q4, s4
// 16-byte aligned; pdl: launched dependent on the kernel before it.
extern "C" int vstar_int4_w4a8(const void* xq, const void* q4, const void* s4, const void* sx,
                               void* y, long long rows, long long in, long long out,
                               long long group, long long cluster, long long aligned,
                               long long y_f32, long long pdl, void* stream) {
  if (rows < 1 || rows > vstar::kMaxRows || group < 128 || group % 128 || in % group ||
      in % 16)
    return (int)cudaErrorInvalidValue;
  return run_w4a8<VSTAR_K6_DECODE>(
      false, (int)rows, aligned != 0, nullptr, xq, static_cast<const uint8_t*>(q4),
      static_cast<const float*>(s4), static_cast<const float*>(sx), y, in, out, (int)group,
      (int)cluster, (int)y_f32, pdl != 0, static_cast<cudaStream_t>(stream));
}

// The row quantization of K6's qdot: xq [rows, in] int8 and sx [rows] f32
// from x [rows, in] (bf16, or f32 with x_f32), each row's max |value| from
// amax [rows] f32 where it is not null; in % 8 == 0, x 16-byte and xq
// 8-byte aligned.
extern "C" int vstar_w4a8_quantize(const void* x, void* xq, void* sx, const void* amax,
                                   long long rows, long long in, long long x_f32,
                                   void* stream) {
  if (rows < 1 || in < 8 || in % 8) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<int8_t*>(xq);
  auto* s = static_cast<float*>(sx);
  auto* m = static_cast<const float*>(amax);
  if (x_f32)
    w4a8_quantize_kernel<float><<<(unsigned)rows, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), q, s, m, in);
  else
    w4a8_quantize_kernel<bf16><<<(unsigned)rows, kQuantThreads, 0, st>>>(
        static_cast<const bf16*>(x), q, s, m, in);
  return (int)cudaGetLastError();
}
