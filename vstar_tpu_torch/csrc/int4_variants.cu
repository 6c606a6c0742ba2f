// P1-P4: the kernels of the int4 profile (vstar_tpu_torch/scripts/
// int4_profile.py) on sm_90a.
//
// They replace the Pallas kernels of scripts/int4_profile.py, the JAX
// package's experiment on the W4A8 (K6) design. Weight format as K6's
// (nn/quant.quantize_weight_int4): q4 uint8 [IN/2, OUT], packed row p holds
// input 2p in its low nibble and 2p+1 in its high nibble, both
// two's-complement signed; s4 f32 [NG, OUT].
//
// P1 (probe_mosaic, k_mul / k_add): u8 q -> int8 (q & 0xF) << 4, the lo
//   nibble times 16, as one per-byte int8 multiply by 16 (HOW 0) or as four
//   doublings (HOW 1). Elementwise, bound by the bytes.
// P2 (_w4a8_call with _w4a8_kernel_mul / _2and / _off and the shipping
//   _w4a8_kernel): K6's function, f32 y[R, OUT] = per group the exact int32
//   dot of xq with 16 * nibble, times s4 / 16, with a given lo-nibble unpack:
//     ship  (b << 4) & 0xF0 per byte (K6's);
//     mul   a per-byte int8 multiply by 16;
//     2and  dot(xe, b & 7) - dot(xe, b & 8) as two __dp4a streams;
//     off   offset binary (b ^ 8) & 0xF = lo + 8, less 8 * sum(xe) per group
//           (one __dp4a against 0x01010101).
//   A block owns COLS (= the TPU's block_o, 256 or 512) columns and one split
//   of the groups; each thread holds 4 columns and walks "quads" of 4 packed
//   rows (8 inputs), so the activations pair as xe = inputs 8k, +2, +4, +6
//   and xo = the odd ones, read from global memory (x is at most 16 rows,
//   cached). Bound by the packed weight bytes.
// P3 (_w4a8_call_rows): K6's function with the grid over blocks of block_i
//   packed rows, each block reading whole rows of the [IN/2, OUT] array
//   (1024 columns per CUDA block, grid.y covers OUT); each block's f32 sum
//   over its groups goes to an f32 workspace [blocks, R, OUT] that
//   splitk_finish adds in block order, as the TPU's `o_ref += acc` did.
// P4 (_w4a8_call_t): K6's function on transposed storage, q4t u8 [OUT, IN/2]
//   and s4t f32 [OUT, NG]: K6's decode rows in their W4A8T format
//   (decode_rows.cuh). A word of one output's row is four packed inputs,
//   so the two masks give two m16n8k32 A registers with no byte permute;
//   a ring stage holds 32 packed bytes of each of a strip's 128 rows, and
//   the scales of a group are gathered one per row. One launch, no
//   workspace, the k-splits added across a cluster, as K6. block_o (the
//   TPU's grid) selects nothing here: every strip is 128 rows.
//
// Every group dot is exact in int32 and scaled as d * (s4 / 16); splits are
// added in order (deterministic, no atomics). The domain is the TPU
// functions': R <= 16, OUT % block_o == 0; the quads need IN % 8 == 0 and a
// group of a multiple of 8 inputs (P4: of 64, IN % 32 == 0).
#include "decode_rows.cuh"
#include "quant_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsCols = 4 * kThreads;   // P3: columns of one CUDA block

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

// The lo nibble times 16 of each byte of w, as int8 bytes.
template <int HOW>
__device__ __forceinline__ uint32_t lo_times16(uint32_t w) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int8_t v = (int8_t)(w >> (8 * j));
    if constexpr (HOW == 0) {
      v = (int8_t)(v * 16);       // wraps mod 256: (v & 0xF) << 4
    } else {
      v = (int8_t)(v + v);
      v = (int8_t)(v + v);
      v = (int8_t)(v + v);
      v = (int8_t)(v + v);
    }
    r |= (uint32_t)(uint8_t)v << (8 * j);
  }
  return r;
}

template <int HOW>
__global__ void __launch_bounds__(kThreads)
    unpack_probe_kernel(const uint8_t* __restrict__ q, int8_t* __restrict__ o,
                        long long n, int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 16;
    for (long long i = tid; i < nv; i += stride) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + i);
      v.x = lo_times16<HOW>(v.x);
      v.y = lo_times16<HOW>(v.y);
      v.z = lo_times16<HOW>(v.z);
      v.w = lo_times16<HOW>(v.w);
      reinterpret_cast<uint4*>(o)[i] = v;
    }
    done = nv * 16;
  }
  for (long long i = done + tid; i < n; i += stride)
    o[i] = (int8_t)(lo_times16<HOW>(q[i]) & 0xFFu);
}

// ---------------------------------------------------------------------------
// Shared pieces of P2-P4
// ---------------------------------------------------------------------------

enum Unpack { kShip = 0, kMul = 1, kTwoAnd = 2, kOff = 3 };

// xe / xo words of activation row xrow for quad k (inputs 8k .. 8k+7).
__device__ __forceinline__ void x_words(const int8_t* __restrict__ xrow, long long k,
                                        int& xe, int& xo) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(xrow) + k);
  xe = (int)__byte_perm(v.x, v.y, 0x6420);
  xo = (int)__byte_perm(v.x, v.y, 0x7531);
}

// Words w[i] hold 4 columns of packed row i of a quad; c[j] gathers column
// j over the 4 rows (byte i = row i).
__device__ __forceinline__ void columns(const uint32_t (&w)[4], int (&c)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t u0 = __byte_perm(w[2], w[3], 0x5140), u1 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = (int)__byte_perm(t0, u0, 0x5410);
  c[1] = (int)__byte_perm(t0, u0, 0x7632);
  c[2] = (int)__byte_perm(t1, u1, 0x5410);
  c[3] = (int)__byte_perm(t1, u1, 0x7632);
}

// Adds one quad (row words a[4], 4 columns) into the int32 dots d[r][j]
// with the UNPACK's arithmetic; for kOff also sums xe into cs[r].
template <int RB, int UNPACK>
__device__ __forceinline__ void quad_dots(const uint32_t (&a)[4], const int (&xe)[RB],
                                          const int (&xo)[RB], int (&d)[RB][4],
                                          int (&cs)[RB]) {
  uint32_t w[4];
  int hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = a[i] & 0xF0F0F0F0u;
  columns(w, hi);
  if constexpr (UNPACK == kTwoAnd) {
    int l7[4], m8[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = a[i] & 0x07070707u;
    columns(w, l7);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = a[i] & 0x08080808u;
    columns(w, m8);
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[r][j] = __dp4a(xo[r], hi[j],
                         d[r][j] + 16 * (__dp4a(xe[r], l7[j], 0) - __dp4a(xe[r], m8[j], 0)));
  } else if constexpr (UNPACK == kOff) {
    int lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = (a[i] ^ 0x08080808u) & 0x0F0F0F0Fu;
    columns(w, lo);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      cs[r] = __dp4a(xe[r], 0x01010101, cs[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[r][j] = __dp4a(xo[r], hi[j], d[r][j] + 16 * __dp4a(xe[r], lo[j], 0));
    }
  } else {
    int lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = UNPACK == kMul ? lo_times16<0>(a[i]) : (a[i] << 4) & 0xF0F0F0F0u;
    columns(w, lo);
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[r][j] = __dp4a(xo[r], hi[j], __dp4a(xe[r], lo[j], d[r][j]));
  }
}

// ---------------------------------------------------------------------------
// P2
// ---------------------------------------------------------------------------

// Block (strip of COLS columns, split): groups [split * gchunk, ...). Lane l
// of a column thread walks quads l, l + TR, ... of each group; the lanes'
// f32 partials are added in lane order in shared memory and stored to split
// `blockIdx.y` of ws [splits, rows, out].
template <int RB, int UNPACK, int COLS>
__global__ void __launch_bounds__(kThreads)
    w4a8_variant_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ q4,
                        const float* __restrict__ s4, float* __restrict__ ws, int rows,
                        long long in, long long out, int group, long long gchunk,
                        long long ng) {
  constexpr int TC = COLS / 4;
  constexpr int TR = kThreads / TC;
  extern __shared__ float red[];                  // [RB][4][TC]
  const int tc = threadIdx.x % TC, lane = threadIdx.x / TC;
  const long long c0 = (long long)blockIdx.x * COLS + tc * 4;
  const long long g0 = (long long)blockIdx.y * gchunk;
  const long long g1 = min(ng, g0 + gchunk);
  const int quads = group / 8;                    // per group
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  for (long long g = g0; g < g1; ++g) {
    int d[RB][4], cs[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      cs[r] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) d[r][j] = 0;
    }
    for (int k = lane; k < quads; k += TR) {
      const long long quad = g * quads + k;
      const uint8_t* wp = q4 + 4 * quad * out + c0;
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = __ldg(reinterpret_cast<const uint32_t*>(wp + i * out));
      int xe[RB], xo[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) x_words(xq + r * in, quad, xe[r], xo[r]);
        else xe[r] = xo[r] = 0;
      }
      quad_dots<RB, UNPACK>(a, xe, xo, d, cs);
    }
    const float4 s = __ldg(reinterpret_cast<const float4*>(s4 + g * out + c0));
    const float sc[4] = {s.x * (1.f / 16.f), s.y * (1.f / 16.f), s.z * (1.f / 16.f),
                         s.w * (1.f / 16.f)};
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dd = UNPACK == kOff ? d[r][j] - 128 * cs[r] : d[r][j];
        acc[r][j] += (float)dd * sc[j];
      }
  }
  for (int l = 0; l < TR; ++l) {
    if (lane == l) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* dst = red + (r * 4 + j) * TC + tc;
          *dst = (l == 0 ? 0.f : *dst) + acc[r][j];
        }
    }
    __syncthreads();
  }
  const long long strip = (long long)blockIdx.x * COLS;
  for (int i = threadIdx.x; i < RB * COLS; i += kThreads) {
    const int r = i / COLS, col = i % COLS;
    if (r < rows)
      ws[((long long)blockIdx.y * rows + r) * out + strip + col] =
          red[(r * 4 + col % 4) * TC + col / 4];
  }
}

// ---------------------------------------------------------------------------
// P3
// ---------------------------------------------------------------------------

// Block (row block i, column block): packed rows [i * block_i, ...), columns
// [blockIdx.y * 1024, ...); each thread 4 columns over every quad of the
// row block; ws [row blocks, rows, out].
template <int RB>
__global__ void __launch_bounds__(kThreads)
    w4a8_rows_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ q4,
                     const float* __restrict__ s4, float* __restrict__ ws, int rows,
                     long long in, long long out, int group, int block_i) {
  const long long c0 = (long long)blockIdx.y * kRowsCols + threadIdx.x * 4;
  if (c0 >= out) return;
  const int quads = group / 8;
  const int ngb = block_i / (group / 2);
  const long long gb = (long long)blockIdx.x * ngb;
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  for (long long g = gb; g < gb + ngb; ++g) {
    int d[RB][4], cs[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      cs[r] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) d[r][j] = 0;
    }
    for (int k = 0; k < quads; ++k) {
      const long long quad = g * quads + k;
      const uint8_t* wp = q4 + 4 * quad * out + c0;
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = __ldg(reinterpret_cast<const uint32_t*>(wp + i * out));
      int xe[RB], xo[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) x_words(xq + r * in, quad, xe[r], xo[r]);
        else xe[r] = xo[r] = 0;
      }
      quad_dots<RB, kShip>(a, xe, xo, d, cs);
    }
    const float4 s = __ldg(reinterpret_cast<const float4*>(s4 + g * out + c0));
    const float sc[4] = {s.x * (1.f / 16.f), s.y * (1.f / 16.f), s.z * (1.f / 16.f),
                         s.w * (1.f / 16.f)};
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] += (float)d[r][j] * sc[j];
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (r < rows) {
      float* dst = ws + ((long long)blockIdx.x * rows + r) * out + c0;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int RB, int UNPACK, int COLS>
int launch_p2(const int8_t* xq, const uint8_t* q4, const float* s4, float* ws, void* y,
              int rows, long long in, long long out, int group, long long gchunk,
              int splits, cudaStream_t st) {
  const size_t smem = sizeof(float) * RB * COLS;
  dim3 grid((unsigned)(out / COLS), (unsigned)splits);
  w4a8_variant_kernel<RB, UNPACK, COLS><<<grid, kThreads, smem, st>>>(
      xq, q4, s4, ws, rows, in, out, group, gchunk, in / group);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_finish(ws, splits, rows, out, nullptr, y, 0, st);
}

template <int RB, int UNPACK>
int launch_p2_cols(int cols, const int8_t* xq, const uint8_t* q4, const float* s4, float* ws,
                   void* y, int rows, long long in, long long out, int group,
                   long long gchunk, int splits, cudaStream_t st) {
  return cols == 512
             ? launch_p2<RB, UNPACK, 512>(xq, q4, s4, ws, y, rows, in, out, group, gchunk,
                                          splits, st)
             : launch_p2<RB, UNPACK, 256>(xq, q4, s4, ws, y, rows, in, out, group, gchunk,
                                          splits, st);
}

template <int RB>
int launch_p2_unpack(int unpack, int cols, const int8_t* xq, const uint8_t* q4,
                     const float* s4, float* ws, void* y, int rows, long long in,
                     long long out, int group, long long gchunk, int splits,
                     cudaStream_t st) {
  switch (unpack) {
    case kShip: return launch_p2_cols<RB, kShip>(cols, xq, q4, s4, ws, y, rows, in, out, group, gchunk, splits, st);
    case kMul: return launch_p2_cols<RB, kMul>(cols, xq, q4, s4, ws, y, rows, in, out, group, gchunk, splits, st);
    case kTwoAnd: return launch_p2_cols<RB, kTwoAnd>(cols, xq, q4, s4, ws, y, rows, in, out, group, gchunk, splits, st);
    default: return launch_p2_cols<RB, kOff>(cols, xq, q4, s4, ws, y, rows, in, out, group, gchunk, splits, st);
  }
}

template <int RB>
int launch_p3(const int8_t* xq, const uint8_t* q4, const float* s4, float* ws, void* y,
              int rows, long long in, long long out, int group, int block_i,
              cudaStream_t st) {
  const long long blocks = (in / 2) / block_i;
  dim3 grid((unsigned)blocks, (unsigned)((out + kRowsCols - 1) / kRowsCols));
  w4a8_rows_kernel<RB><<<grid, kThreads, 0, st>>>(xq, q4, s4, ws, rows, in, out, group,
                                                  block_i);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_finish(ws, (int)blocks, rows, out, nullptr, y, 0, st);
}

template <int RB>
int occupancy_p2(int unpack, int cols, int* blocks) {
  const size_t smem = sizeof(float) * RB * cols;
#define VSTAR_P2_OCC(U)                                                                  \
  return (int)(cols == 512 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
                                 blocks, w4a8_variant_kernel<RB, U, 512>, kThreads, smem) \
                           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
                                 blocks, w4a8_variant_kernel<RB, U, 256>, kThreads, smem))
  switch (unpack) {
    case kShip: VSTAR_P2_OCC(kShip);
    case kMul: VSTAR_P2_OCC(kMul);
    case kTwoAnd: VSTAR_P2_OCC(kTwoAnd);
    default: VSTAR_P2_OCC(kOff);
  }
#undef VSTAR_P2_OCC
}

// Shared argument checks of P2-P4: rows 1..16, group a multiple of 8 that
// divides in, in % 8 == 0 (8-byte activation loads).
bool bad_args(long long rows, long long in, long long out, long long group) {
  return rows < 1 || rows > vstar::kMaxRows || group < 8 || group % 8 || in % group ||
         in % 8 || out < 1;
}

bool bad_split(long long ng, long long gchunk, long long splits) {
  return gchunk < 1 || splits < 1 || (splits - 1) * gchunk >= ng || splits * gchunk < ng;
}

}  // namespace

#define VSTAR_RB_SWITCH(rb, CALL) \
  switch (rb) {                   \
    case 1: return CALL(1);       \
    case 2: return CALL(2);       \
    case 4: return CALL(4);       \
    case 8: return CALL(8);       \
    default: return CALL(16);     \
  }

// P1: o [n] int8 = (q [n] & 0xF) << 4, by a per-byte multiply (how 0) or
// four doublings (how 1). 16-byte vectors where both pointers allow it.
extern "C" int vstar_unpack_probe(const void* q, void* o, long long n, long long how,
                                  void* stream) {
  if (n < 1 || how < 0 || how > 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int vec = (reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(o) % 16 == 0);
  const long long units = vec ? (n + 15) / 16 : n;
  const long long want = (units + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  auto* qb = static_cast<const uint8_t*>(q);
  auto* ob = static_cast<int8_t*>(o);
  if (how == 0)
    unpack_probe_kernel<0><<<blocks, kThreads, 0, st>>>(qb, ob, n, vec);
  else
    unpack_probe_kernel<1><<<blocks, kThreads, 0, st>>>(qb, ob, n, vec);
  return (int)cudaGetLastError();
}

// Blocks per SM of P2 (`unpack` 0-3, `cols` 256 / 512) for `rows`, into
// *blocks.
extern "C" int vstar_int4_variants_occupancy(long long unpack, long long rows, long long cols,
                                             void* blocks) {
  auto* b = static_cast<int*>(blocks);
  const int u = (int)unpack, c = (int)cols;
#define VSTAR_OCC(RB) occupancy_p2<RB>(u, c, b)
  VSTAR_RB_SWITCH(row_bucket(rows), VSTAR_OCC)
#undef VSTAR_OCC
}

// P2: y [rows, out] f32 = xq [rows, in] int8 @ nib(q4 [in/2, out]) with
// per-group int32 dots times s4 [in/group, out] / 16; `unpack` 0 ship, 1 mul,
// 2 2and, 3 off; `cols` (block_o) 256 or 512 dividing out; ws f32 [splits,
// rows, out], split i covers groups [i * gchunk, (i + 1) * gchunk).
// Contiguous operands; xq 8-, q4 4- and s4 16-byte aligned.
extern "C" int vstar_w4a8_variant(const void* xq, const void* q4, const void* s4, void* ws,
                                  void* y, long long rows, long long in, long long out,
                                  long long group, long long unpack, long long cols,
                                  long long gchunk, long long splits, void* stream) {
  if (bad_args(rows, in, out, group) || unpack < 0 || unpack > 3 ||
      (cols != 256 && cols != 512) || out % cols || bad_split(in / group, gchunk, splits))
    return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const int8_t*>(xq);
  auto* qb = static_cast<const uint8_t*>(q4);
  auto* sf = static_cast<const float*>(s4);
  auto* wf = static_cast<float*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  const int r = (int)rows, g = (int)group, u = (int)unpack, c = (int)cols, sp = (int)splits;
#define VSTAR_P2(RB) launch_p2_unpack<RB>(u, c, xb, qb, sf, wf, y, r, in, out, g, gchunk, sp, st)
  VSTAR_RB_SWITCH(row_bucket(rows), VSTAR_P2)
#undef VSTAR_P2
}

// P3: P2's function (shipping unpack) over blocks of block_i packed rows (a
// multiple of group / 2 dividing in / 2); ws f32 [in / 2 / block_i, rows,
// out]. out % 4 == 0; xq 8-, q4 4-, s4 and ws 16-byte aligned.
extern "C" int vstar_w4a8_rows(const void* xq, const void* q4, const void* s4, void* ws,
                               void* y, long long rows, long long in, long long out,
                               long long group, long long block_i, void* stream) {
  if (bad_args(rows, in, out, group) || out % 4 || block_i < 1 || block_i % (group / 2) ||
      (in / 2) % block_i)
    return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const int8_t*>(xq);
  auto* qb = static_cast<const uint8_t*>(q4);
  auto* sf = static_cast<const float*>(s4);
  auto* wf = static_cast<float*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  const int r = (int)rows, g = (int)group, bi = (int)block_i;
#define VSTAR_P3(RB) launch_p3<RB>(xb, qb, sf, wf, y, r, in, out, g, bi, st)
  VSTAR_RB_SWITCH(row_bucket(rows), VSTAR_P3)
#undef VSTAR_P3
}

// P4's decode-row shape: 64 packed bytes (one group) of each row a
// stage, 3 stages, one warp per 128-row strip, two k-splits a block
// (kernel_probe.py --k6-shapes; PERF.md).
#define VSTAR_P4_DECODE kFmtW4A8T, 64, 3, 1, 2, 0

// Blocks of P4's kernel for `rows` (<= 16) that one SM holds, into *blocks.
extern "C" int vstar_w4a8_t_occupancy(long long rows, void* blocks) {
  long long vals[6];
  const int err = run_w4a8<VSTAR_P4_DECODE>(true, (int)rows, true, vals, nullptr, nullptr,
                                            nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, false,
                                            nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Build facts of P4's i-th instantiation (rows 8 / 16); -1 past the last.
extern "C" int vstar_w4a8_t_kernel_info(int i, const char** name, long long* vals) {
  static const char* names[] = {"w4a8t_decode<8>", "w4a8t_decode<16>"};
  if (i < 0 || i > 1) return -1;
  *name = names[i];
  return run_w4a8<VSTAR_P4_DECODE>(true, i ? 16 : 8, true, vals, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, 0, 0, 0, 0, 1, false, nullptr);
}

// P4: y [rows, out] f32 = P2's function on transposed storage q4t [out,
// in/2], s4t [out, in/group]; group % 128 == 0, in % 32 == 0, q4t 16-byte
// aligned, contiguous operands, xq 16-byte aligned; `cluster` (1..16)
// blocks per strip of 128 output rows.
extern "C" int vstar_w4a8_t(const void* xq, const void* q4t, const void* s4t, void* y,
                            long long rows, long long in, long long out, long long group,
                            long long cluster, void* stream) {
  if (bad_args(rows, in, out, group) || group % 128 || in % 32)
    return (int)cudaErrorInvalidValue;
  return run_w4a8<VSTAR_P4_DECODE>(false, (int)rows, true, nullptr, xq,
                                   static_cast<const uint8_t*>(q4t),
                                   static_cast<const float*>(s4t), nullptr, y, in, out,
                                   (int)group, (int)cluster, 1, false,
                                   static_cast<cudaStream_t>(stream));
}
