// K3 + K4: weight-only int8 matvec for decode-shaped rows on sm_90a.
//
// Replaces two Pallas kernels of the JAX package that compute the same
// function, y[R, OUT] = (x[R, IN] @ q int8 [IN, OUT]) * s f32 [OUT] for
// R <= 16: vstar_tpu/kernels/int8_matmul.py:_kernel (K3, a grid over output
// blocks with x resident) and vstar_tpu/kernels/stream_matvec.py:_kernel
// (K4, the same product with the weight streamed through a two-slot VMEM
// buffer by hand-issued DMAs, which existed only to hide the TPU's copy
// latency).
//
// What bounds it on the H100: the weight bytes. At R <= 16 the product
// does 2 * R operations per weight byte, far below the ~295 per byte where
// the bf16 tensor cores would become the limit; 4096 x 11008 int8 is 45.1
// MB, 13.5 us at 3.35 TB/s. The design is K5's tensor-core decode rows
// (decode_rows.cuh) for int8 bytes: each weight byte is unpacked exactly
// into a bf16 mma operand without an integer-to-float conversion, x and
// the weights stream through a cp.async ring per k-split, the products run
// on mma.sync with f32 accumulation, the k-splits of a strip are added in
// order through distributed shared memory across a thread-block cluster,
// and the column scale is applied once, after that sum. One launch, no
// workspace, no atomics. The earlier CUDA-core design (an I2F per weight
// byte, 2R FMAs per byte on CUDA cores, a split-K workspace and a second
// launch to add it up) was 2.2-6.1x the byte bound.
//
// VSTAR_K3_DECODE is the shipped (format, ring rows per stage, stages,
// warps along the columns, k-splits per block, L2 prefetch); it won
// kernel_probe.py --k3-shapes (k3_probe.cu; PERF.md), which sweeps the
// others.
#include "decode_rows.cuh"

#define VSTAR_K3_DECODE kFmtInt8, 32, 3, 1, 2, 0

// Blocks of K3's kernel for `rows` (<= 16) that one SM holds, into
// *blocks; `aligned` as for vstar_int8_matvec.
extern "C" int vstar_int8_decode_occupancy(long long rows, long long aligned, void* blocks) {
  long long vals[6];
  const int err = run_decode<VSTAR_K3_DECODE>(true, (int)rows, aligned != 0, vals, nullptr,
                                              nullptr, nullptr, nullptr, 0, 0, 0, 0, 0,
                                              nullptr);
  *static_cast<int*>(blocks) = (int)vals[4];
  return err;
}

// Build facts of K3's i-th instantiation (rows 8 / 16, aligned / ragged),
// as vstar_attention_kernel_info reports them; -1 past the last.
extern "C" int vstar_int8_kernel_info(int i, const char** name, long long* vals) {
  static const char* names[] = {"int8_decode<8, aligned>", "int8_decode<16, aligned>",
                                "int8_decode<8, ragged>", "int8_decode<16, ragged>"};
  if (i < 0 || i > 3) return -1;
  *name = names[i];
  return run_decode<VSTAR_K3_DECODE>(true, i % 2 ? 16 : 8, i < 2, vals, nullptr, nullptr,
                                     nullptr, nullptr, 0, 0, 0, 0, 0, nullptr);
}

// y [rows, out] bf16 = (x [rows, in] bf16 @ q [in, out] int8) * s [out] f32,
// rows <= 16, q and s contiguous; x rows xs apart (xs % 8 == 0, xs >= in,
// x zero in [in, xs), x 16-byte aligned). `cluster` (1..8) blocks per
// strip of 128 columns; aligned: out % 16 == 0 and q 16-byte aligned.
extern "C" int vstar_int8_matvec(const void* x, const void* q, const void* s, void* y,
                                 long long rows, long long in, long long out, long long xs,
                                 long long cluster, long long aligned, void* stream) {
  if (rows < 1 || rows > 16 || in < 1 || xs < in || xs % 8)
    return (int)cudaErrorInvalidValue;
  return run_decode<VSTAR_K3_DECODE>(
      false, (int)rows, aligned != 0, nullptr, static_cast<const bf16*>(x),
      static_cast<const uint8_t*>(q), static_cast<const float*>(s), static_cast<bf16*>(y), in,
      out, xs, 0, (int)cluster, static_cast<cudaStream_t>(stream));
}
