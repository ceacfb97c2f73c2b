// Forward tile rasterizer (K2) on packed instance rows, 32-byte viewer rows
// or 16-byte training rows (template parameter PACKED16).
//
// Replaces splatjax/ops/rasterize.py::_fwd_kernel (the Pallas kernel called
// by rasterize_cm_fwd), both row decodes. The TPU kernel streams
// chunk-major feature blocks through a DMA ring, evaluates the Gaussian
// power as a (P, 6) x (6, 128) MXU product and turns the within-chunk
// transmittance scan into triangular matmuls, then flips its (P, C)
// accumulators to planar rows with identity matmuls. Those are MXU/VMEM
// artefacts; this kernel is the standard CUDA 3DGS tile rasterizer.
//
// What bounds it on the H100: the per-fragment arithmetic and the deepest
// tiles' latency, not bytes (32 B per instance read once per tile, 8 KB
// written per tile). Each walked fragment (instance x pixel) costs the
// 6-term power polynomial and, inside the exp(-4) support, exp + log1p +
// exp. On the 1M-splat 1920x1080 frame (an H100 SXM at 700 W) the
// deepest tile walks 3,238 instances, 14x the mean, and alone takes over
// half of the whole frame's kernel time; taken heaviest first and walked
// by 8 warps (composite.cuh), it no longer finishes last.
//
// Design: the shared fragment loop of composite.cuh (instantiated for
// tile edges 8, 16, 32 and 64, chosen by the entry's tile argument; one
// thread-block cluster per tile at 32 and 64 px), fed by a row source
// that loads one 32-byte row (two 16-byte loads) per instance and decodes
// it (rows.cuh). The 16-byte rows decode exactly as splatjax's
// unpack_chunk16 (mean at 1/8 px with a 2048 px bias, bf16 conic halves,
// u16 opacity, RGB8, f32 depth in lane 4); the fragment math after the
// decode is the same f32 code for both layouts. splatjax's 16-byte mode
// also switches to single-pass bf16 MXU scans; this kernel does not (f32
// throughout).

#include <cuda_runtime.h>

#include "composite.cuh"
#include "rows.cuh"

namespace {

template <bool PACKED16>
struct PackedRows {
  const int4* rows;

  __device__ __forceinline__ Decoded operator()(long long k) const {
    return decode_row<PACKED16>(rows, k);
  }
};

// one block per tile (8 and 16 px)
template <int TILE, bool PACKED16>
__global__ void __launch_bounds__(Composite<TILE>::THREADS)
rasterize_fwd_kernel(PackedRows<PACKED16> src, CompositeArgs args) {
  composite_tile<TILE>(src, args);
}

// one cluster per tile (32 and 64 px), held to 64 registers a thread
template <int TILE, bool PACKED16>
__global__ void __launch_bounds__(Composite<TILE>::THREADS,
                                  Composite<TILE>::MIN_BLOCKS)
rasterize_fwd_cluster_kernel(PackedRows<PACKED16> src, CompositeArgs args) {
  composite_tile<TILE>(src, args);
}

// K2's kernel at tile edge TILE
template <int TILE, bool PACKED16>
auto fwd_kernel() {
  if constexpr (Composite<TILE>::CLUSTER > 1) {
    return rasterize_fwd_cluster_kernel<TILE, PACKED16>;
  } else {
    return rasterize_fwd_kernel<TILE, PACKED16>;
  }
}

template <int TILE>
int fwd_attributes(int packed16, int* out) {
  using G = Composite<TILE>;
  return packed16 ? kernel_attributes<G::CLUSTER>(fwd_kernel<TILE, true>(),
                                                  G::THREADS, 0, out)
                  : kernel_attributes<G::CLUSTER>(fwd_kernel<TILE, false>(),
                                                  G::THREADS, 0, out);
}

template <int TILE>
int launch_fwd(const int4* rows, const CompositeArgs& args, int num_tiles,
               int packed16, cudaStream_t stream) {
  if (packed16) {
    return launch_composite<TILE>(fwd_kernel<TILE, true>(), num_tiles,
                                  stream, PackedRows<true>{rows}, args);
  }
  return launch_composite<TILE>(fwd_kernel<TILE, false>(), num_tiles, stream,
                                PackedRows<false>{rows}, args);
}

}  // namespace

// rows: (K, 8) int32 packed instance rows, tile-sorted (16-byte training
// rows when packed16); starts/ends: (num_tiles,) int32; order:
// (num_tiles,) int32 permutation of the tiles, heaviest first; zbuf:
// (num_tiles, P) f32 camera z or null; out: (num_tiles, 8, P) f32, with
// P = tile * tile. tile: the square tile edge, 8, 16, 32 or 64; any other
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int splat_rasterize_fwd(const int* rows, const int* starts,
                                   const int* ends, const int* order,
                                   const float* zbuf,
                                   float* out, int num_tiles, int tiles_x,
                                   int tile, int has_clip, float log_clip,
                                   int clamp_log_om, float log_eps,
                                   int packed16, cudaStream_t stream) {
  if (tile != 8 && tile != 16 && tile != 32 && tile != 64) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  const int4* r = reinterpret_cast<const int4*>(rows);
  const CompositeArgs args{starts,  ends,     order,        zbuf,
                           out,     tiles_x,  has_clip,     log_clip,
                           clamp_log_om, log_eps};
  switch (tile) {
    case 8: return launch_fwd<8>(r, args, num_tiles, packed16, stream);
    case 16: return launch_fwd<16>(r, args, num_tiles, packed16, stream);
    case 32: return launch_fwd<32>(r, args, num_tiles, packed16, stream);
    default: return launch_fwd<64>(r, args, num_tiles, packed16, stream);
  }
}

// out: 5 int32, kernel_attributes (launch.cuh) of the K2 instantiation at
// tile edge tile (8, 16, 32 or 64) and row width (packed16): registers a
// thread, local memory bytes a thread (spills), the largest block, blocks
// an SM, clusters on the device.
extern "C" int splat_rasterize_fwd_attributes(int tile, int packed16,
                                              int* out) {
  switch (tile) {
    case 8: return fwd_attributes<8>(packed16, out);
    case 16: return fwd_attributes<16>(packed16, out);
    case 32: return fwd_attributes<32>(packed16, out);
    case 64: return fwd_attributes<64>(packed16, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
