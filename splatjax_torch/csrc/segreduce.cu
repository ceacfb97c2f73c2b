// Deterministic per-gaussian sums of gradient rows (K5, K6, K7).
//
// Replaces splatjax/ops/segreduce.py::_segreduce_kernel (K5, f32 rows),
// ::_segreduce_u16_kernel (K6, biased-u16 pairs) and
// ::_segreduce_bf16_kernel (K7, bf16 pairs). The TPU kernels sum runs of
// gid-sorted rows with one-hot selection matmuls on the MXU over 128/1024-
// row DMA windows, because the MXU cannot gather; the u16 variant splits
// each value into 8-bit limbs so the bf16 MXU passes stay exact. Hopper
// gathers, so the rows need not be sorted by gaussian at all.
//
// Two entries, one kernel body over a run policy:
//  * direct (splat_segreduce_f32/_packed): rows grouped by gaussian;
//    gaussian g owns rows [g ? eff_cum[g-1] : 0, eff_cum[g]) -> out row g.
//  * slots (splat_segreduce_slots_f32/_packed): rows in tile order, as the
//    backward writes them. Depth rank r owns the depth-major expansion
//    slots [min(cum_d[r-1], k), min(cum_d[r], k)); slot s sits at
//    row slot_pos[s] (the inverse of the stable tile sort) -> out row
//    perm[r]. A gaussian's slots ascend in tile id, and the tile sort is
//    stable, so its rows come in the order a stable sort by gid gives them:
//    the same sums, added in the same order, with no sort and no row copy.
// Either way every one of the n output rows is written, empty runs as 0.
//
// Decodes: f32 rows of C = 4L channels (K5); (K, 8) int32 lanes of biased
// u16 pairs, channel c low and c + 8 high, summed exactly in integers and
// rounded once to f32 (K6, bit-equal to splatjax's limb arithmetic); the
// same lanes as bf16 pairs (K7).
//
// What bounds it on the H100: bytes. Each valid slot reads its row once
// (32 B packed, 64 B f32 at C = 16) and, through slot_pos, 4 B more; each
// gaussian reads 8 B (its run end and output row) and writes 64 B. Runs
// are short (2.8 rows on average at 1M splats, 1080p), so the design is
// about keeping enough independent loads in flight, not about arithmetic.
//
// Design: a lane reads 16 bytes of a row (uint4), so a row is L lanes
// (L = 2 packed, C / 4 for f32) and a warp holds 32 / L gaussians, one lane
// group each. A group issues the slot_pos loads, then the row loads, of up
// to UNROLL rows before the first add depends on them, adds them in run
// order, and writes its output row as float4s. Runs longer than LONG_RUN
// are left to the whole block after the short ones: its THREADS / L row
// slots each add every (THREADS / L)-th row of the run in order, then a
// fixed shuffle tree and the warps' partials in warp order. The order of
// every add is fixed by the run's length alone, so two runs of the kernel
// are bit-identical. K6 adds in int32, exact while a run holds at most
// 65,537 rows (65,537 x 32,767 < 2^31); the block sums a longer run
// (possible only past 65,537 tiles, beyond 4K) in chunks of that many rows
// and adds the chunks' sums in int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;              // row loads in flight per lane
constexpr int LONG_RUN = 32;           // longer runs: the whole block
constexpr int CHUNK_ROWS = 65537;      // K6: int32 sums exact up to here
constexpr unsigned FULL = 0xFFFFFFFFu;

// --- run policies: which rows a run adds, and where its sum goes ---------

struct Direct {
  const int* __restrict__ eff_cum;
  __device__ __forceinline__ void run(int i, int* a, int* b, int* row) const {
    *a = i > 0 ? __ldg(eff_cum + i - 1) : 0;
    *b = __ldg(eff_cum + i);
    *row = i;
  }
  __device__ __forceinline__ int pos(int s) const { return s; }
};

struct Slots {
  const int* __restrict__ slot_pos;
  const int* __restrict__ cum_d;
  const int* __restrict__ perm;
  int k;
  __device__ __forceinline__ void run(int r, int* a, int* b, int* row) const {
    *a = min(r > 0 ? __ldg(cum_d + r - 1) : 0, k);
    *b = min(__ldg(cum_d + r), k);
    *row = __ldg(perm + r);
  }
  __device__ __forceinline__ int pos(int s) const {
    return __ldg(slot_pos + s);
  }
};

// --- decodes: one 16-byte lane of a row into VALS accumulators ----------

// K5: four f32 channels; the lane's part p holds channels 4p .. 4p + 3.
struct F32 {
  using acc_t = float;
  using total_t = float;
  static constexpr int VALS = 4;
  __device__ __forceinline__ static void add(acc_t* acc, uint4 v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  template <typename T>
  __device__ __forceinline__ static void store(float* row, int part,
                                               const T* acc) {
    reinterpret_cast<float4*>(row)[part] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

// K6 and K7: four int32 lanes of packed pairs; part p holds planes
// 4p .. 4p + 3, i.e. channels 4p .. 4p + 3 (low halves, acc 0-3) and
// 8 + 4p .. 8 + 4p + 3 (high halves, acc 4-7) of the 16-wide output.
template <typename Acc, typename Total, typename Half>
struct Pairs {
  using acc_t = Acc;
  using total_t = Total;  // sum of a long run's chunks
  static constexpr int VALS = 8;
  __device__ __forceinline__ static void add(acc_t* acc, uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] += Half::lo(w[i]);
      acc[4 + i] += Half::hi(w[i]);
    }
  }
  template <typename T>
  __device__ __forceinline__ static void store(float* row, int part,
                                               const T* acc) {
    float4* r = reinterpret_cast<float4*>(row);
    r[part] = make_float4((float)acc[0], (float)acc[1], (float)acc[2],
                          (float)acc[3]);
    r[2 + part] = make_float4((float)acc[4], (float)acc[5], (float)acc[6],
                              (float)acc[7]);
  }
};

struct U16Half {
  __device__ __forceinline__ static int lo(uint32_t w) {
    return (int)(w & 0xFFFFu) - 32768;
  }
  __device__ __forceinline__ static int hi(uint32_t w) {
    return (int)(w >> 16) - 32768;
  }
};

struct Bf16Half {
  __device__ __forceinline__ static float lo(uint32_t w) {
    return __uint_as_float(w << 16);
  }
  __device__ __forceinline__ static float hi(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
  }
};

using U16 = Pairs<int, long long, U16Half>;
using BF16 = Pairs<float, float, Bf16Half>;

// --- the sums -----------------------------------------------------------

// Lane `part` of a group adds its 16 bytes of the rows s = a, a + step,
// ... < b (step 1 for a group, the block's row slots for a long run), in
// that order, UNROLL rows' loads issued before their adds.
template <class Dec, int L, class Src>
__device__ __forceinline__ void add_rows(const uint4* __restrict__ rows,
                                         const Src& src, int a, int b,
                                         int step, int part,
                                         typename Dec::acc_t* acc) {
  for (int s0 = a; s0 < b; s0 += step * UNROLL) {
    int p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * step;
      p[u] = s < b ? src.pos(s) : 0;
    }
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s0 + u * step < b) {
        v[u] = __ldg(rows + (long long)p[u] * L + part);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s0 + u * step < b) Dec::add(acc, v[u]);
    }
  }
}

// Rows [a, b) of a long run summed by the whole block; the sums end in
// acc of threads 0 .. L-1 (thread p holds part p).
template <class Dec, int L, class Src>
__device__ void block_sum(const uint4* __restrict__ rows, const Src& src,
                          int a, int b, typename Dec::acc_t* acc,
                          void* red_raw) {
  using acc_t = typename Dec::acc_t;
  constexpr int V = Dec::VALS;
  const int part = threadIdx.x % L;
  const int slot = threadIdx.x / L;
  add_rows<Dec, L>(rows, src, a + slot, b, THREADS / L, part, acc);
  // fixed tree over the warp's row slots: lanes part, part + L, ...
#pragma unroll
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += __shfl_down_sync(FULL, acc[v], off);
  }
  acc_t* red = reinterpret_cast<acc_t*>(red_raw);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane < L) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[(warp * L + lane) * V + v] = acc[v];
  }
  __syncthreads();
  if (threadIdx.x < L) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = red[threadIdx.x * V + v];
    for (int w = 1; w < WARPS; ++w) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += red[(w * L + threadIdx.x) * V + v];
    }
  }
  __syncthreads();  // red is reused by the next chunk or run
}

// One block: THREADS / L runs i = blockIdx.x * GROUPS + group.
template <class Dec, int L, class Src>
__global__ void __launch_bounds__(THREADS)
    segsum_kernel(const uint4* __restrict__ rows, Src src,
                  float* __restrict__ out, int n, int width) {
  constexpr int GROUPS = THREADS / L;
  __shared__ int s_long[GROUPS];
  __shared__ int s_nlong;
  __shared__ __align__(16) unsigned s_red[WARPS * 32];  // [WARPS][L][V]
  const int part = threadIdx.x % L;
  const int i = blockIdx.x * GROUPS + threadIdx.x / L;
  if (threadIdx.x == 0) s_nlong = 0;
  __syncthreads();
  if (i < n) {
    int a, b, row;
    src.run(i, &a, &b, &row);
    if (b - a > LONG_RUN) {
      // the list's order depends on the atomics; each run's sum does not
      if (part == 0) s_long[atomicAdd(&s_nlong, 1)] = i;
    } else {
      typename Dec::acc_t acc[Dec::VALS];
#pragma unroll
      for (int v = 0; v < Dec::VALS; ++v) acc[v] = 0;
      add_rows<Dec, L>(rows, src, a, b, 1, part, acc);
      Dec::store(out + (long long)row * width, part, acc);
    }
  }
  __syncthreads();
  const int nlong = s_nlong;
  for (int j = 0; j < nlong; ++j) {
    int a, b, row;
    src.run(s_long[j], &a, &b, &row);
    typename Dec::total_t total[Dec::VALS];
#pragma unroll
    for (int v = 0; v < Dec::VALS; ++v) total[v] = 0;
    for (int c0 = a; c0 < b; c0 += CHUNK_ROWS) {
      typename Dec::acc_t acc[Dec::VALS];
#pragma unroll
      for (int v = 0; v < Dec::VALS; ++v) acc[v] = 0;
      block_sum<Dec, L>(rows, src, c0, min(b, c0 + CHUNK_ROWS), acc, s_red);
#pragma unroll
      for (int v = 0; v < Dec::VALS; ++v) total[v] += acc[v];
    }
    if (threadIdx.x < L) {
      Dec::store(out + (long long)row * width, threadIdx.x, total);
    }
  }
}

template <class Dec, int L, class Src>
int launch(const void* rows, const Src& src, float* out, int n, int width,
           cudaStream_t stream) {
  constexpr int GROUPS = THREADS / L;
  const int blocks = (int)(((long long)n + GROUPS - 1) / GROUPS);
  segsum_kernel<Dec, L, Src><<<blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const uint4*>(rows), src, out, n, width);
  return (int)cudaGetLastError();
}

// f32 rows of c = 4, 8, 16 or 32 channels (L = c / 4 lanes a row).
template <class Src>
int launch_f32(const float* rows, const Src& src, float* out, int n, int c,
               cudaStream_t stream) {
  switch (c) {
    case 4: return launch<F32, 1>(rows, src, out, n, c, stream);
    case 8: return launch<F32, 2>(rows, src, out, n, c, stream);
    case 16: return launch<F32, 4>(rows, src, out, n, c, stream);
    case 32: return launch<F32, 8>(rows, src, out, n, c, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// (K, 8) int32 packed pairs: mode 0 = biased u16 (K6), 1 = bf16 (K7).
template <class Src>
int launch_packed(const int* rows, const Src& src, float* out, int n,
                  int mode, cudaStream_t stream) {
  return mode == 0 ? launch<U16, 2>(rows, src, out, n, 16, stream)
                   : launch<BF16, 2>(rows, src, out, n, 16, stream);
}

}  // namespace

// Direct entries. rows: (K, c) f32 or (K, 8) int32, 16-byte aligned;
// eff_cum: (n,) int32 inclusive run ends; out: (n, c) or (n, 16) f32.
extern "C" int splat_segreduce_f32(const float* rows, const int* eff_cum,
                                   float* out, int n, int c,
                                   cudaStream_t stream) {
  if (n == 0) return 0;
  return launch_f32(rows, Direct{eff_cum}, out, n, c, stream);
}

extern "C" int splat_segreduce_packed(const int* rows, const int* eff_cum,
                                      float* out, int n, int mode,
                                      cudaStream_t stream) {
  if (n == 0) return 0;
  return launch_packed(rows, Direct{eff_cum}, out, n, mode, stream);
}

// Slot entries. rows: (k, c) f32 or (k, 8) int32 in tile order; slot_pos:
// (k,) int32; cum_d, perm: (n,) int32 in depth order.
extern "C" int splat_segreduce_slots_f32(const float* rows,
                                         const int* slot_pos,
                                         const int* cum_d, const int* perm,
                                         float* out, int n, int k, int c,
                                         cudaStream_t stream) {
  if (n == 0) return 0;
  return launch_f32(rows, Slots{slot_pos, cum_d, perm, k}, out, n, c,
                    stream);
}

extern "C" int splat_segreduce_slots_packed(const int* rows,
                                            const int* slot_pos,
                                            const int* cum_d,
                                            const int* perm, float* out,
                                            int n, int k, int mode,
                                            cudaStream_t stream) {
  if (n == 0) return 0;
  return launch_packed(rows, Slots{slot_pos, cum_d, perm, k}, out, n, mode,
                       stream);
}
