// Row pack and gather: each instance's packed row built straight from the
// (N, 16) f32 per-gaussian features through its gaussian id, in
// splatjax's 32-byte viewer layout or its 16-byte training layout
// (ops/rasterize.py documents both).
//
// Replaces no TPU kernel: splatjax packs the (N, 8) table
// (splatjax/ops/rasterize.py pack_feature_table, pack_feature_table16)
// and gathers it (gather_chunk_major) in jnp, which XLA fuses. Eager
// PyTorch ran that as ~30 elementwise kernels (~58 for the 16-byte
// layout) and a cat or stack over all N gaussians, an int64 copy of the
// ids, and index_select over the capacity K, whose row gather is bound
// by latency at ~2% of the card's bandwidth.
//
// What bounds it on the H100: bytes. Each instance reads its 4-byte id
// and the two 32-byte sectors of its gaussian's 64-byte feature row that
// hold lanes 0-9, and writes one 32-byte row: 100 B an instance, 0.70 GB
// at K = 7M, 0.21 ms at 3.35 TB/s. The feature reads are random (tile
// order), so what keeps the card from that bound is how many loads are
// in flight.
//
// Design:
// * each thread takes PER instances, THREADS apart, so that a warp's
//   loads of the ids and its stores of the rows are contiguous. It first
//   issues all PER id loads, then all 3 PER loads of the feature rows
//   (two 16-byte loads of lanes 0-7, one 8-byte load of lanes 8-9; the
//   rows are 64 bytes, 16-byte aligned), and packs only once they are in
//   registers: 3 PER independent loads in flight a thread;
// * neighbouring threads write neighbouring 32-byte rows, two int4
//   stores each;
// * the layout is a template parameter;
// * every step is the plain composition's (ops/rasterize.py
//   pack_feature_table, pack_feature_table16, as torch runs them on the
//   card), so the rows are bit-equal to it: f32 products and sums rounded
//   one by one (no FMA contraction), torch's clamp (NaN passes through),
//   floor, then clamp, then torch's float -> int32 conversion (a plain
//   cast), and the bf16 rounding c10::BFloat16 takes on sm_80 and above
//   (__float2bfloat16). Lanes and shifts in 32-bit unsigned arithmetic,
//   as torch's shifts of int32.
//
// Contract: gid holds K ids in [0, N); an id outside traps, as torch's
// index_select asserts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;          // instances a thread
constexpr int FEAT = 16;        // floats a feature row

// torch's clamp: NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch's float -> int32 conversion on the card
__device__ __forceinline__ unsigned to_i32(float x) {
  return (unsigned)static_cast<int>(x);
}

// ops/rasterize.py _quant16 (scale 65535) and _quant8 (255)
__device__ __forceinline__ unsigned quant(float x, float scale) {
  return to_i32(
      floorf(__fadd_rn(__fmul_rn(clamp_nan(x, 0.0f, 1.0f), scale), 0.5f)));
}

// ops/rasterize.py _quant_mean16: 1/8 px, biased by 2048 px
__device__ __forceinline__ unsigned quant_mean16(float x) {
  return to_i32(clamp_nan(
      floorf(__fadd_rn(__fmul_rn(__fadd_rn(x, 2048.0f), 8.0f), 0.5f)), 0.0f,
      65535.0f));
}

// ops/rasterize.py _bf16_bits_hi, the low half
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(x));
}

// Features 0-3 (a), 4-7 (b), 8-9 (c) -> the row's two int4 halves.
template <bool PACKED16>
__device__ __forceinline__ void pack(const float4 a, const float4 b,
                                     const float2 c, int4& lo, int4& hi) {
  if (PACKED16) {
    lo.x = (int)((quant_mean16(a.x) << 16) | quant_mean16(a.y));
    lo.y = (int)((bf16_bits(a.z) << 16) | bf16_bits(a.w));
    lo.z = (int)((bf16_bits(b.x) << 16) | quant(c.x, 65535.0f));
    lo.w = (int)((quant(b.y, 255.0f) << 24) | (quant(b.z, 255.0f) << 16) |
                 (quant(b.w, 255.0f) << 8));
    hi = make_int4(__float_as_int(c.y), 0, 0, 0);
  } else {
    lo = make_int4(__float_as_int(a.x), __float_as_int(a.y),
                   __float_as_int(a.z), __float_as_int(a.w));
    hi = make_int4(
        __float_as_int(b.x),
        (int)((quant(b.y, 65535.0f) << 16) | quant(b.z, 65535.0f)),
        (int)((quant(b.w, 65535.0f) << 16) | quant(c.x, 65535.0f)),
        __float_as_int(c.y));
  }
}

template <bool PACKED16>
__global__ void __launch_bounds__(THREADS)
    pack_rows_kernel(const float* __restrict__ feat,
                     const int* __restrict__ gid, int n, long long k,
                     int4* __restrict__ rows) {
  const long long first =
      (long long)blockIdx.x * (THREADS * PER) + threadIdx.x;
  int g[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const long long i = first + (long long)j * THREADS;
    g[j] = i < k ? __ldg(gid + i) : 0;
  }
  bool bad = false;
#pragma unroll
  for (int j = 0; j < PER; ++j) bad |= (unsigned)g[j] >= (unsigned)n;
  if (bad) __trap();
  float4 a[PER], b[PER];
  float2 c[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float4* row =
        reinterpret_cast<const float4*>(feat + (long long)g[j] * FEAT);
    a[j] = __ldg(row);
    b[j] = __ldg(row + 1);
    c[j] = __ldg(reinterpret_cast<const float2*>(row + 2));
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const long long i = first + (long long)j * THREADS;
    if (i < k) {
      int4 lo, hi;
      pack<PACKED16>(a[j], b[j], c[j], lo, hi);
      rows[2 * i] = lo;
      rows[2 * i + 1] = hi;
    }
  }
}

}  // namespace

// feat: (n, 16) f32, 16-byte aligned; gid: (k,) int32 in [0, n), n >= 1
// when k > 0; rows: (k, 8) int32 out, 16-byte aligned. packed16 picks the
// 16-byte training layout.
extern "C" int splat_pack_rows(const float* feat, int n, const int* gid,
                               long long k, int packed16, int* rows,
                               cudaStream_t stream) {
  if (k == 0) return 0;
  const long long per_block = (long long)THREADS * PER;
  const unsigned blocks = (unsigned)((k + per_block - 1) / per_block);
  int4* out = reinterpret_cast<int4*>(rows);
  if (packed16) {
    pack_rows_kernel<true><<<blocks, THREADS, 0, stream>>>(feat, gid, n, k,
                                                           out);
  } else {
    pack_rows_kernel<false><<<blocks, THREADS, 0, stream>>>(feat, gid, n, k,
                                                            out);
  }
  return (int)cudaGetLastError();
}
