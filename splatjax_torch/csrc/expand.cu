// Instance expansion (K1): depth-ordered gaussians -> per-instance
// (tile id, gaussian id).
//
// Replaces splatjax/ops/expand.py::_expand_kernel (the Pallas kernel
// called by expand_instances). The TPU kernel has no vector gather, so it
// reassembles each slot's gaussian from a one-hot MXU contraction over a
// DMA'd window of a 16-row f32 table with 8-bit limbs. Hopper gathers
// natively, so none of that carries over.
//
// Contract: slot j < min(total, capacity) belongs to the depth-ordered
// gaussian g = #{r : cum_d[r] <= j}; with local = j - cum_d[g-1] it holds
// tile (y0 + local / w) * tiles_x + x0 + local % w and gid perm[g]. Slots
// past the end hold (num_tiles, n - 1). total = cum_d[n-1] is read on the
// device, so the host never waits for it.
//
// What bounds it on the H100: bytes, 8 per slot written and 20 per gaussian
// read. A thread per slot with its own ~20-step binary search over cum_d
// is latency-bound instead: 20 dependent loads per slot.
//
// Design: one block per window of WINDOW = THREADS x PER consecutive slots.
// The block finds the window's first gaussian g0 by a 256-way search
// (each round every thread tests one cum_d entry, __syncthreads_count picks
// the interval: three rounds at 1M gaussians) and stages cum_d[g0 - 1 ..
// g0 + WINDOW) in shared memory. Before total every gaussian owns at least
// one slot (depth_order keys the empty ones to the tail), so the window's
// slots fall on the staged gaussians; a slot past them (possible only for
// interior empty runs) searches the whole cum_d. A thread takes PER
// consecutive slots: one binary search in shared memory for the first,
// then a forward walk, and stores its PER tiles and ids as int4s. Every
// slot's value depends on the inputs alone: deterministic, integer-equal
// to the plain version. Indices are int32; splatjax's <=255-tiles-per-axis
// and < 2^24-capacity limits (bf16 limbs) do not apply here.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                    // consecutive slots a thread
constexpr int WINDOW = THREADS * PER;     // slots a block

// first r in [lo, hi) with cum_d[r] > j (hi if none), over global memory
__device__ int search_global(const int* __restrict__ cum_d, int lo, int hi,
                             int j) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cum_d + mid) <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    expand_kernel(const int* __restrict__ x0_d, const int* __restrict__ y0_d,
                  const int* __restrict__ spanw_d,
                  const int* __restrict__ cum_d, const int* __restrict__ perm,
                  int n, int capacity, int tiles_x, int num_tiles,
                  int* __restrict__ tile_out, int* __restrict__ gid_out) {
  // s_cum[m] = cum_d[g0 - 1 + m] (0 before the first gaussian, INT_MAX
  // past the last): gaussian g0 + m owns slots [s_cum[m], s_cum[m + 1])
  __shared__ int s_cum[WINDOW + 1];
  const long long j0_64 = (long long)blockIdx.x * WINDOW;
  const int j0 = (int)j0_64;
  const int base = j0 + threadIdx.x * PER;
  const int total = __ldg(cum_d + (n - 1));
  const int limit = total < capacity ? total : capacity;
  int tile[PER], gid[PER];

  if (j0 < limit) {  // block-uniform
    // 256-way search for g0 = first r with cum_d[r] > j0; it exists since
    // j0 < total = cum_d[n - 1]. Invariant: the answer lies in [lo, hi].
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int step = (hi - lo + THREADS - 1) / THREADS;
      const int q = min(lo + threadIdx.x * step, hi);
      // entries below the answer form a prefix of the threads
      const int below = __syncthreads_count(__ldg(cum_d + q) <= j0);
      const int new_lo = below > 0 ? min(lo + (below - 1) * step, hi) + 1
                                   : lo;
      hi = min(lo + below * step, hi);
      lo = new_lo;
    }
    const int g0 = lo;
    for (int m = threadIdx.x; m <= WINDOW; m += THREADS) {
      const int g = g0 - 1 + m;
      s_cum[m] = g < 0 ? 0 : (g < n ? __ldg(cum_d + g) : 0x7FFFFFFF);
    }
    __syncthreads();

    // first slot: smallest m with s_cum[m + 1] > j, by binary search
    int m = 0;
    {
      int a = 0, b = WINDOW;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (s_cum[mid + 1] <= base) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      m = a;
    }
    int g = -1, cum_ex = 0, w = 1, x0 = 0, y0 = 0, id = n - 1;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int j = base + t;
      if (j >= limit) {
        tile[t] = num_tiles;
        gid[t] = n - 1;
        continue;
      }
      while (m < WINDOW && s_cum[m + 1] <= j) ++m;
      int gj, ex;
      if (m < WINDOW) {
        gj = g0 + m;
        ex = s_cum[m];
      } else {  // past the staged gaussians: interior empty runs
        gj = search_global(cum_d, g0 + WINDOW, n, j);
        ex = gj > 0 ? __ldg(cum_d + gj - 1) : 0;
      }
      if (gj != g) {
        g = gj;
        cum_ex = ex;
        w = __ldg(spanw_d + g);
        x0 = __ldg(x0_d + g);
        y0 = __ldg(y0_d + g);
        id = __ldg(perm + g);
      }
      const int local = j - cum_ex;
      const int r = local / w;
      tile[t] = (y0 + r) * tiles_x + x0 + (local - r * w);
      gid[t] = id;
    }
  } else {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      tile[t] = num_tiles;
      gid[t] = n - 1;
    }
  }

  if ((long long)base + PER <= capacity) {
    int4* to = reinterpret_cast<int4*>(tile_out + base);
    int4* go = reinterpret_cast<int4*>(gid_out + base);
#pragma unroll
    for (int t = 0; t < PER; t += 4) {
      to[t / 4] = make_int4(tile[t], tile[t + 1], tile[t + 2], tile[t + 3]);
      go[t / 4] = make_int4(gid[t], gid[t + 1], gid[t + 2], gid[t + 3]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      if (base + t < capacity) {
        tile_out[base + t] = tile[t];
        gid_out[base + t] = gid[t];
      }
    }
  }
}

}  // namespace

extern "C" int splat_expand_instances(const int* x0_d, const int* y0_d,
                                      const int* spanw_d, const int* cum_d,
                                      const int* perm, int n, int capacity,
                                      int tiles_x, int num_tiles,
                                      int* tile_out, int* gid_out,
                                      cudaStream_t stream) {
  const int blocks = (int)(((long long)capacity + WINDOW - 1) / WINDOW);
  expand_kernel<<<blocks, THREADS, 0, stream>>>(
      x0_d, y0_d, spanw_d, cum_d, perm, n, capacity, tiles_x, num_tiles,
      tile_out, gid_out);
  return (int)cudaGetLastError();
}
