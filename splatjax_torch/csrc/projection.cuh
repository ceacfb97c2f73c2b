// The projection arithmetic of one gaussian, shared by K3's in-kernel
// projection (rasterize_cached.cu) and the projection kernels
// (project.cu): camera and clip transforms, the frustum guard, the EWA 2D
// covariance with its +0.3 dilation, the shader's eigen-clamp and the
// conic. Every operation is a round-to-nearest intrinsic in the plain
// PyTorch version's order, so nvcc contracts none of it into an FMA and
// the results are those of the plain versions' separately rounded f32
// ops. Clamps propagate NaN as torch.maximum and jnp.maximum do (fmaxf
// drops it).
#pragma once

#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

constexpr float FRUSTUM_GUARD = 1.2f;
constexpr float SIZE_CULL_THRESHOLD = 1e-4f;

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
// max / min against a constant that keep a NaN, as torch and jnp do
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : fminf(a, b);
}
// row i of a row-major 4x4 matrix applied to (x, y, z, 1), left to right
__device__ __forceinline__ float xform(const float* m, int i, float x,
                                       float y, float z) {
  return add_rn(add_rn(add_rn(mul_rn(m[4 * i], x), mul_rn(m[4 * i + 1], y)),
                 mul_rn(m[4 * i + 2], z)),
             m[4 * i + 3]);
}
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

// The order of a sum of three: LEFT, (x0 + x1) + x2, as an expression
// written out term by term adds (splatjax's cached-row projection and its
// port); REDUCE, (x0 + x2) + x1, as torch's CUDA reduction over a last
// dimension of three adds (sum(dim=-1) in build_covariances and
// project_gaussians; measured on the H100, every element of 1K-3M rows).
enum class Sum3 { LEFT, REDUCE };

template <Sum3 ORDER>
__device__ __forceinline__ float dot3_in(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  if constexpr (ORDER == Sum3::LEFT) {
    return dot3(a0, a1, a2, b0, b1, b2);
  } else {
    return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a2, b2)), mul_rn(a1, b1));
  }
}

// A mean in camera space (cx, cy, cz) and clip space (px, py, pz, w),
// under row-major modelview mv and projection pr.
struct CamPoint {
  float cx, cy, cz, px, py, pz, w;
};

__device__ __forceinline__ CamPoint camera_point(const float* mv,
                                                 const float* pr, float mx,
                                                 float my, float mz) {
  CamPoint p;
  p.cx = xform(mv, 0, mx, my, mz);
  p.cy = xform(mv, 1, mx, my, mz);
  p.cz = xform(mv, 2, mx, my, mz);
  p.px = xform(pr, 0, p.cx, p.cy, p.cz);
  p.py = xform(pr, 1, p.cx, p.cy, p.cz);
  p.pz = xform(pr, 2, p.cx, p.cy, p.cz);
  p.w = xform(pr, 3, p.cx, p.cy, p.cz);
  return p;
}

// the vertex shader's guard band: clip xy within 1.2 w, z past -w
__device__ __forceinline__ bool in_frustum(const CamPoint& p) {
  const float bounds = mul_rn(FRUSTUM_GUARD, p.w);
  return (p.pz >= -p.w) && (p.px >= -bounds) && (p.px <= bounds) &&
         (p.py >= -bounds) && (p.py <= bounds);
}

// focal length in pixels: height / 2 x |pr[1][1]|
__device__ __forceinline__ float focal_px(const float* pr, int height) {
  return mul_rn((float)height * 0.5f, fabsf(pr[5]));
}

// The EWA projection of the covariance (sxx, sxy, sxz; ., syy, syz; ., .,
// szz) at camera point (cx, cy, cz): T = W J collapsed to two row vectors
// t0, t1, the products u0 = S t0 and u1 = S t1, and the dilated 2D
// covariance (a, b; b, c), its dot products summed in ORDER.
struct Ewa {
  float sz, fz, fz2;
  float t0[3], t1[3], u0[3], u1[3];
  float a, b, c;
};

template <Sum3 ORDER>
__device__ __forceinline__ Ewa ewa_cov2d(const float* mv, float focal,
                                         float cx, float cy, float cz,
                                         float sxx, float sxy, float sxz,
                                         float syy, float syz, float szz) {
  Ewa e;
  e.sz = fabsf(cz) < 1e-8f ? 1e-8f : cz;
  e.fz = div_rn(focal, e.sz);
  e.fz2 = div_rn(focal, mul_rn(e.sz, e.sz));
  const float cxf = mul_rn(cx, e.fz2), cyf = mul_rn(cy, e.fz2);
  e.t0[0] = sub_rn(mul_rn(e.fz, mv[0]), mul_rn(cxf, mv[8]));
  e.t0[1] = sub_rn(mul_rn(e.fz, mv[1]), mul_rn(cxf, mv[9]));
  e.t0[2] = sub_rn(mul_rn(e.fz, mv[2]), mul_rn(cxf, mv[10]));
  e.t1[0] = add_rn(mul_rn(-e.fz, mv[4]), mul_rn(cyf, mv[8]));
  e.t1[1] = add_rn(mul_rn(-e.fz, mv[5]), mul_rn(cyf, mv[9]));
  e.t1[2] = add_rn(mul_rn(-e.fz, mv[6]), mul_rn(cyf, mv[10]));
  const float* t0 = e.t0;
  const float* t1 = e.t1;
  e.u0[0] = dot3_in<ORDER>(sxx, sxy, sxz, t0[0], t0[1], t0[2]);
  e.u0[1] = dot3_in<ORDER>(sxy, syy, syz, t0[0], t0[1], t0[2]);
  e.u0[2] = dot3_in<ORDER>(sxz, syz, szz, t0[0], t0[1], t0[2]);
  e.u1[0] = dot3_in<ORDER>(sxx, sxy, sxz, t1[0], t1[1], t1[2]);
  e.u1[1] = dot3_in<ORDER>(sxy, syy, syz, t1[0], t1[1], t1[2]);
  e.u1[2] = dot3_in<ORDER>(sxz, syz, szz, t1[0], t1[1], t1[2]);
  e.a = add_rn(
      dot3_in<ORDER>(t0[0], t0[1], t0[2], e.u0[0], e.u0[1], e.u0[2]), 0.3f);
  e.b = dot3_in<ORDER>(t1[0], t1[1], t1[2], e.u0[0], e.u0[1], e.u0[2]);
  e.c = add_rn(
      dot3_in<ORDER>(t1[0], t1[1], t1[2], e.u1[0], e.u1[1], e.u1[2]), 0.3f);
  return e;
}

// The shader's eigen-clamp of (a, b; b, c): lambda2 >= 0.1, axis lengths
// sqrt(2 lambda) <= 1024 px, the major axis (dvx, dvy) or (1, 0) where
// (b, lambda1 - a) ~ 0. It declares each step as a local of the caller
// (mid, hh, r2, radius, lam1, l2r, lam2, vx, vy, v2, ok, vn, dvx, dvy, s1,
// len1, s2, len2, lam1_raw, lam1_eff, l2e, lam2_eff, inv1, inv2), which the
// backward reads: lam1_raw is lambda1 after the axis clamp alone (the
// support box reads it), lam1_eff and lam2_eff are clamped at 1e-8.
// RADIUS is the radius as an expression of r2: torch.where(r2 > 0,
// sqrt(r2), 0) in the port's projection, sqrt(max(r2, 0)) in splatjax's
// cached-row projection (they differ only at a NaN r2). A macro, expanded
// in the caller's body: written as an inline function, the same arithmetic
// compiled K3's cluster instantiations differently (a 4-byte spill under
// their 64-register cap, 4-5% slower at 32 and 64 px on an H100), while
// expanded in place K3's SASS is what it was before this header.
#define EIGEN_CLAMP(a, b, c, RADIUS)                                      \
  const float mid = mul_rn(0.5f, add_rn(a, c));                          \
  const float hh = mul_rn(0.5f, sub_rn(a, c));                           \
  const float r2 = add_rn(mul_rn(hh, hh), mul_rn(b, b));                 \
  const float radius = RADIUS;                                           \
  const float lam1 = add_rn(mid, radius);                                \
  const float l2r = sub_rn(mid, radius);                                 \
  const float lam2 = max_nan(l2r, 0.1f);                                 \
  const float vx = b, vy = sub_rn(lam1, a);                              \
  const float v2 = add_rn(mul_rn(vx, vx), mul_rn(vy, vy));               \
  const bool ok = v2 > 1e-24f;                                           \
  const float vn = sqrt_rn(ok ? v2 : 1.0f);                              \
  const float dvx = ok ? div_rn(vx, vn) : 1.0f;                          \
  const float dvy = ok ? div_rn(vy, vn) : 0.0f;                          \
  const float s1 = sqrt_rn(mul_rn(2.0f, lam1));                          \
  const float len1 = min_nan(s1, 1024.0f);                               \
  const float s2 = sqrt_rn(mul_rn(2.0f, max_nan(lam2, 0.0f)));           \
  const float len2 = min_nan(s2, 1024.0f);                               \
  const float lam1_raw = mul_rn(mul_rn(0.5f, len1), len1);               \
  const float lam1_eff = max_nan(lam1_raw, 1e-8f);                       \
  const float l2e = mul_rn(mul_rn(0.5f, len2), len2);                    \
  const float lam2_eff = max_nan(l2e, 1e-8f);                            \
  const float inv1 = div_rn(1.0f, lam1_eff);                             \
  const float inv2 = div_rn(1.0f, lam2_eff)

// The conic (A, B, C) the clamped covariance inverts to: A is
// conic_a(inv1, inv2, dvx, dvy), B conic_b(...), C conic_a(inv1, inv2,
// dvy, dvx).
__device__ __forceinline__ float conic_a(float inv1, float inv2, float dvx,
                                         float dvy) {
  return add_rn(mul_rn(mul_rn(inv1, dvx), dvx), mul_rn(mul_rn(inv2, dvy), dvy));
}
__device__ __forceinline__ float conic_b(float inv1, float inv2, float dvx,
                                         float dvy) {
  return mul_rn(mul_rn(sub_rn(inv1, inv2), dvx), dvy);
}

// the pixel center of a clip point: ((x / w + 1) W / 2, (y / w + 1) H / 2)
__device__ __forceinline__ float safe_w(float w) {
  return fabsf(w) < 1e-8f ? 1e-8f : w;
}
__device__ __forceinline__ float to_pixel(float p, float sw, int size) {
  return mul_rn(add_rn(div_rn(p, sw), 1.0f), (float)size * 0.5f);
}

}  // namespace
