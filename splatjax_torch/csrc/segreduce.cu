// Deterministic segmented sum of gid-sorted gradient rows (K5, K6, K7).
//
// Replaces splatjax/ops/segreduce.py::_segreduce_kernel (K5, f32 rows),
// ::_segreduce_u16_kernel (K6, biased-u16 pairs) and
// ::_segreduce_bf16_kernel (K7, bf16 pairs). The TPU kernels sum runs with
// one-hot selection matmuls on the MXU over 128/1024-row DMA windows,
// because the MXU cannot gather; the u16 variant splits each value into
// 8-bit limbs so the bf16 MXU passes stay exact. None of that is needed on
// Hopper: a warp reads its run directly.
//
// Contract: rows are instance-major and grouped by gaussian; gaussian g
// owns rows [g ? eff_cum[g-1] : 0, eff_cum[g]). Output (N, 16) f32 (K6, K7)
// or (N, C) f32 (K5), one row per gaussian, every row written.
//
// What bounds it on the H100: bytes. Each row is read once (64 B for f32
// rows of 16 channels, 32 B packed) and 64 B are written per gaussian;
// the adds are negligible. Runs are short (about 3 rows per gaussian at
// 1M splats), so the first version is latency-bound, not bandwidth-bound.
//
// Design: one warp per gaussian, no atomics. The warp splits into G lane
// groups of W lanes (W = channels or packed planes). Lane (grp, c) sums
// channel c over rows a + grp, a + grp + G, ... in order; the groups are
// then combined by a fixed shuffle tree. The order of every add is fixed,
// so the result is the same on every run. K6 sums the unbiased u16 values
// in 64-bit integers and casts once: the exact sum, rounded once to f32,
// which is what splatjax's limb arithmetic returns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void run_bounds(const int* __restrict__ eff_cum,
                                           int g, int* a, int* b) {
  *a = g > 0 ? eff_cum[g - 1] : 0;
  *b = eff_cum[g];
}

// K5: f32 rows (K, C), C in {1, 2, 4, 8, 16, 32}.
__global__ void segreduce_f32_kernel(const float* __restrict__ rows,
                                     const int* __restrict__ eff_cum,
                                     float* __restrict__ out, int n, int c) {
  const int g = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  if (g >= n) return;
  const int lane = threadIdx.x % 32;
  const int groups = 32 / c;
  const int grp = lane / c, ch = lane % c;
  int a, b;
  run_bounds(eff_cum, g, &a, &b);
  float acc = 0.0f;
  for (int r = a + grp; r < b; r += groups) {
    acc += rows[(long long)r * c + ch];
  }
  for (int off = 16; off >= c; off >>= 1) {
    acc += __shfl_down_sync(FULL, acc, off);
  }
  if (lane < c) out[(long long)g * c + ch] = acc;
}

// K6 (U16) and K7 (BF16): packed rows (K, 8) int32, channel c in the low
// half and c + 8 in the high half. 4 groups of 8 lanes.
template <bool U16>
__global__ void segreduce_packed_kernel(const uint32_t* __restrict__ rows,
                                        const int* __restrict__ eff_cum,
                                        float* __restrict__ out, int n) {
  const int g = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  if (g >= n) return;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 8, ch = lane % 8;
  int a, b;
  run_bounds(eff_cum, g, &a, &b);
  float lo_f = 0.0f, hi_f = 0.0f;
  long long lo_i = 0, hi_i = 0;
  for (int r = a + grp; r < b; r += 4) {
    const uint32_t u = rows[(long long)r * 8 + ch];
    if (U16) {
      lo_i += (long long)(u & 0xFFFFu) - 32768;
      hi_i += (long long)(u >> 16) - 32768;
    } else {
      lo_f += __uint_as_float(u << 16);
      hi_f += __uint_as_float(u & 0xFFFF0000u);
    }
  }
  for (int off = 16; off >= 8; off >>= 1) {
    if (U16) {
      lo_i += __shfl_down_sync(FULL, lo_i, off);
      hi_i += __shfl_down_sync(FULL, hi_i, off);
    } else {
      lo_f += __shfl_down_sync(FULL, lo_f, off);
      hi_f += __shfl_down_sync(FULL, hi_f, off);
    }
  }
  if (lane < 8) {
    float* o = out + (long long)g * 16;
    o[ch] = U16 ? (float)lo_i : lo_f;
    o[ch + 8] = U16 ? (float)hi_i : hi_f;
  }
}

int blocks_for(int n) { return (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK; }

}  // namespace

// rows: (K, c) f32; eff_cum: (n,) int32 inclusive run ends; out: (n, c).
extern "C" int splat_segreduce_f32(const float* rows, const int* eff_cum,
                                   float* out, int n, int c,
                                   cudaStream_t stream) {
  if (n == 0) return 0;
  segreduce_f32_kernel<<<blocks_for(n), WARPS_PER_BLOCK * 32, 0, stream>>>(
      rows, eff_cum, out, n, c);
  return (int)cudaGetLastError();
}

// rows: (K, 8) int32 packed pairs; mode 0 = biased u16 (K6), 1 = bf16 (K7);
// out: (n, 16) f32.
extern "C" int splat_segreduce_packed(const int* rows, const int* eff_cum,
                                      float* out, int n, int mode,
                                      cudaStream_t stream) {
  if (n == 0) return 0;
  const uint32_t* r = reinterpret_cast<const uint32_t*>(rows);
  if (mode == 0) {
    segreduce_packed_kernel<true>
        <<<blocks_for(n), WARPS_PER_BLOCK * 32, 0, stream>>>(r, eff_cum, out,
                                                             n);
  } else {
    segreduce_packed_kernel<false>
        <<<blocks_for(n), WARPS_PER_BLOCK * 32, 0, stream>>>(r, eff_cum, out,
                                                             n);
  }
  return (int)cudaGetLastError();
}
