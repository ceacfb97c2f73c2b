// Fused cached-viewer forward (K3): projection of cached per-instance
// parameters under the current camera, then K2's fragment loop, in one
// kernel.
//
// Replaces splatjax/ops/rasterize.py::_cached_fwd_kernel (the Pallas kernel
// called by rasterize_cached_fwd). The TPU kernel streams group-major
// blocks of 8 chunks through a 6-slot DMA ring, projects a whole group at
// once so the math fills (8, 128) vregs, carries the projected group from
// one sequential grid step to the next in SMEM, and runs the power and the
// color sum as bf16 MXU matmuls. None of that carries over: blocks run in
// no order here, and the rows stay instance-major (64 B per instance, four
// 16-byte loads).
//
// What bounds it on the H100: as for K2, the per-fragment arithmetic and
// the deepest tiles' latency; the projection adds about 190 f32 operations
// per walked instance, 1/P of a tile's P fragments each, and the rows are
// 64 B instead of 32 B. Against stale bins the deepest tile can lose its
// early stop: at an orbit eye of the 1M-splat 1920x1080 frame it walks
// 4,793 instances (3,238 at the bins' camera), and that one tile alone
// sets most of the kernel's time (measured on an H100 SXM at 700 W).
//
// Design: the shared fragment loop of composite.cuh (one block per tile,
// one thread-block cluster at 32 and 64 px, taken heaviest first,
// instantiated for tile edges 8, 16, 32 and 64 and chosen by the entry's
// tile argument; at 16 px two pixels a thread,
// globally aligned 128-instance chunks split between two thread groups,
// __syncthreads_or early stop), fed by a row source that loads one cached
// row and projects it:
// * the row is [mean xyz, cov6 (xx xy xz yy yz zz), rgb, opacity,
//   max_scale, 0, 0] (splatjax's pack_cached_rows);
// * the camera (row-major modelview and projection, width, height) is a
//   by-value kernel argument, so a frame copies nothing to the device;
// * the projection is splatjax's _project_rows op for op: frustum guard,
//   cz < 0 and size culls, the +0.3 dilation, the eigen clamps, every cull
//   folded into opacity = 0, in the arithmetic of projection.cuh that the
//   projection kernels (project.cu) share. It is written with
//   round-to-nearest intrinsics, so nvcc contracts none of it into FMAs
//   and the result is bit-equal to the plain version's separately rounded
//   f32 ops: an ulp on the mean at x ~ 1000 px would move fragments on the
//   exp(-4) cutoff.
//   Clamps propagate NaN as torch.maximum and jnp.maximum do (fmaxf drops
//   it), so a degenerate instance decodes to the same values in both;
// * at 16 px the first thread group (128 threads, one row each) projects
//   a chunk's rows; the second, which composites the chunk's back half,
//   waits at the barrier. K3 takes about 3% longer than K2 on the same
//   16 px frame, for the projection and the 64-byte rows together, so the
//   idle group costs at most that. At 8 px a row serves a quarter of the
//   pixels, and all 128 threads of the block project one row each;
// * at 32 and 64 px a cluster of 4 or 16 blocks composites a tile, and
//   every block projects the whole chunk itself, CLUSTER times the
//   projections; under the cluster kernels' 64-register cap (4 blocks an
//   SM) K3 stays within a few percent of K2 there. Splitting the
//   projection over the cluster and copying the records through
//   distributed shared memory took 111 registers a thread (spills under
//   the cap) and was slower (PERF.md, cluster_variants.py).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "composite.cuh"
#include "projection.cuh"
#include "rows.cuh"

namespace {

struct CachedCamera {
  float mv[16];  // world -> camera, row-major
  float pr[16];  // camera -> clip, row-major
  int width;
  int height;
};

struct CachedRows {
  const float4* prm;  // (K, 4) float4 = (K, 16) f32 cached rows
  CachedCamera cam;

  __device__ __forceinline__ Decoded operator()(long long k) const {
    const float4 q0 = __ldg(prm + 4 * k);
    const float4 q1 = __ldg(prm + 4 * k + 1);
    const float4 q2 = __ldg(prm + 4 * k + 2);
    const float4 q3 = __ldg(prm + 4 * k + 3);
    const float mex = q0.x, mey = q0.y, mez = q0.z;
    const float sxx = q0.w, sxy = q1.x, sxz = q1.y;
    const float syy = q1.z, syz = q1.w, szz = q2.x;
    const float opa = q3.x, max_scale = q3.y;
    const CamPoint p = camera_point(cam.mv, cam.pr, mex, mey, mez);
    const bool keep =
        in_frustum(p) && (p.cz < 0.0f) &&
        (mul_rn(max_scale, opa) > mul_rn(SIZE_CULL_THRESHOLD, -p.cz));
    const Ewa e =
        ewa_cov2d<Sum3::LEFT>(cam.mv, focal_px(cam.pr, cam.height), p.cx,
                              p.cy, p.cz, sxx, sxy, sxz, syy, syz, szz);
    const float a = e.a, b = e.b, c = e.c;
    EIGEN_CLAMP(a, b, c, sqrt_rn(max_nan(r2, 0.0f)));

    const float sw = safe_w(p.w);
    Decoded d;
    d.mx = to_pixel(p.px, sw, cam.width);
    d.my = to_pixel(p.py, sw, cam.height);
    d.ca = conic_a(inv1, inv2, dvx, dvy);
    d.cb = conic_b(inv1, inv2, dvx, dvy);
    d.cc = conic_a(inv1, inv2, dvy, dvx);
    d.r = q2.y;
    d.g = q2.z;
    d.b = q2.w;
    d.opa = keep ? opa : 0.0f;
    d.depth = p.cz;
    return d;
  }
};

// one block per tile (8 and 16 px)
template <int TILE>
__global__ void __launch_bounds__(Composite<TILE>::THREADS)
rasterize_cached_kernel(CachedRows src, CompositeArgs args) {
  composite_tile<TILE>(src, args);
}

// one cluster per tile (32 and 64 px), held to 64 registers a thread
template <int TILE>
__global__ void __launch_bounds__(Composite<TILE>::THREADS,
                                  Composite<TILE>::MIN_BLOCKS)
rasterize_cached_cluster_kernel(CachedRows src, CompositeArgs args) {
  composite_tile<TILE>(src, args);
}

// K3's kernel at tile edge TILE
template <int TILE>
auto cached_kernel() {
  if constexpr (Composite<TILE>::CLUSTER > 1) {
    return rasterize_cached_cluster_kernel<TILE>;
  } else {
    return rasterize_cached_kernel<TILE>;
  }
}

template <int TILE>
int cached_attributes(int* out) {
  using G = Composite<TILE>;
  return kernel_attributes<G::CLUSTER>(cached_kernel<TILE>(), G::THREADS, 0,
                                       out);
}

}  // namespace

// out: 5 int32, kernel_attributes (launch.cuh) of the K3 instantiation at
// tile edge tile (8, 16, 32 or 64): registers a thread, local memory bytes
// a thread (spills), the largest block, blocks an SM, clusters on the
// device.
extern "C" int splat_rasterize_cached_attributes(int tile, int* out) {
  switch (tile) {
    case 8: return cached_attributes<8>(out);
    case 16: return cached_attributes<16>(out);
    case 32: return cached_attributes<32>(out);
    case 64: return cached_attributes<64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// prm: (K, 16) f32 cached parameter rows in tile order, 16-byte aligned;
// mv, pr: host pointers to the row-major 4x4 modelview and projection (read
// here, passed to the kernel by value); starts/ends: (num_tiles,) int32;
// order: (num_tiles,) int32 permutation of the tiles, heaviest first; out:
// (num_tiles, 8, P) f32, with P = tile * tile. tile: the square tile edge,
// 8, 16, 32 or 64; any other returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int splat_rasterize_cached_fwd(const float* prm, const float* mv,
                                          const float* pr, int width,
                                          int height, const int* starts,
                                          const int* ends, const int* order,
                                          float* out,
                                          int num_tiles, int tiles_x,
                                          int tile, int has_clip,
                                          float log_clip, int clamp_log_om,
                                          float log_eps,
                                          cudaStream_t stream) {
  if (tile != 8 && tile != 16 && tile != 32 && tile != 64) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return 0;
  CachedRows src;
  src.prm = reinterpret_cast<const float4*>(prm);
  for (int i = 0; i < 16; ++i) {
    src.cam.mv[i] = mv[i];
    src.cam.pr[i] = pr[i];
  }
  src.cam.width = width;
  src.cam.height = height;
  const CompositeArgs args{starts,  ends,     order,        nullptr,
                           out,     tiles_x,  has_clip,     log_clip,
                           clamp_log_om, log_eps};
  switch (tile) {
    case 8:
      return launch_composite<8>(cached_kernel<8>(), num_tiles, stream, src,
                                 args);
    case 16:
      return launch_composite<16>(cached_kernel<16>(), num_tiles, stream,
                                  src, args);
    case 32:
      return launch_composite<32>(cached_kernel<32>(), num_tiles, stream,
                                  src, args);
    default:
      return launch_composite<64>(cached_kernel<64>(), num_tiles, stream,
                                  src, args);
  }
}
