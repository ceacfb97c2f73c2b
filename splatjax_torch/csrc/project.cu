// Gaussian projection and its closed-form backward, one thread a gaussian:
// the covariance R diag(s^2) R^T from quaternion and scales (or a cached
// upper triangle), the viewer's int16 round trip, the EWA projection, the
// frustum, size and cutout culls, the eigen-clamp and conic, the support
// box with its opacity-aware shrink, and SH up to degree 3.
//
// Replaces no TPU kernel: splatjax's projection (splatjax/ops/projection.py
// project_gaussians after splatjax/scene.py build_covariances) is jnp code
// that XLA fuses on the TPU. Eager PyTorch cannot fuse: the same
// composition is about a hundred elementwise kernels forward and a few
// hundred in autograd's backward, each a pass over all N gaussians, plus
// the intermediates autograd saves. This pair is one pass each way.
//
// What bounds it on the H100: bytes. At SH 3 the forward reads 236 B a
// gaussian (means 12, quats 16, scales 12, colors 12, opacity 4, sh 180)
// and writes 45 (mean2d 8, conic 12, depth 4, mask 1, support box 8,
// color 12); the backward reads the 232 B of parameters and 36 B of
// cotangents and writes 232 B of gradients. At 3M gaussians that is
// 0.25 ms forward and 0.45 ms backward at 3.35 TB/s; a few hundred f32
// operations a gaussian are far below the operation bound.
//
// Design:
// * one thread a gaussian, four warps a block. A warp's 32 gaussians own
//   a contiguous block of each array's rows (384 B of means, 5,760 B of
//   SH 3). The rows are arrays of structures, 12 and 180 B wide, so a
//   thread reading its own row from device memory would stride by the row
//   width. Instead the warp copies each such block through shared memory
//   with 16-byte loads (16-byte stores for outputs), neighbouring lanes on
//   neighbouring addresses, and each thread then reads its row there.
//   Rows of an even width sit one float apart in shared memory, so that
//   the lanes reading their rows hit distinct banks. 16- and 8-byte rows
//   (quaternions, mean2d, support box) and 4-byte ones move as one vector
//   a thread, already contiguous across the warp;
// * the SH band count (0, 3, 8 or 15, from sh.shape[1]) is a template
//   parameter, so a frame without SH carries no SH registers or shared
//   memory; the covariance source (quats/scales or cov6) is another;
// * the camera (modelview, projection, cutout) is read from device memory
//   by pointer, once a block, into shared memory: the host never waits for
//   the stream to copy it;
// * the backward saves nothing from the forward: it reads the parameters
//   again, recomputes the forward in registers, and takes the derivative
//   that the plain version (ops/projection.py project_backward_plain)
//   writes out line for line: torch autograd's through the plain
//   composition, guards included. It reads the cotangents through a row
//   stride, as the row pack's backward hands them back (strided views of
//   one (N, 16) gradient), so no copy precedes it;
// * the forward's arithmetic is projection.cuh's, round-to-nearest
//   intrinsics in the order the plain composition takes on the card (its
//   reductions summed as torch's CUDA kernels sum them, Sum3::REDUCE and
//   sh_color), so every output, and with them the tile lists, is the plain
//   version's bit for bit. All of it is f32; nothing of the maths is left
//   out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "projection.cuh"

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 4;
constexpr int THREADS = WARP * WARPS;

// floats between rows of W floats in shared memory: odd, so that 32 lanes
// reading their rows float by float hit 32 banks
template <int W>
constexpr int PADDED = W % 2 ? W : W + 1;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// float f of a block of rows of W floats, at its padded place
template <int W>
__device__ __forceinline__ int slot(int f) {
  if constexpr (PADDED<W> == W) {
    return f;
  } else {
    return (f / W) * PADDED<W> + f % W;
  }
}

// A warp's rows [row0, row0 + rows) of an (N, W) array into shared memory,
// with 16-byte loads where the block is 16-byte aligned (a block starts
// 128 W bytes after the last, so always unless the base is not) and float
// loads for the tail.
template <int W>
__device__ __forceinline__ void stage_in(float* smem, const float* src,
                                         long long row0, int rows,
                                         int lane) {
  const float* base = src + row0 * W;
  const int total = rows * W;
  int done = 0;
  if (aligned16(base)) {
    const int vecs = total / 4;
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (int v = lane; v < vecs; v += WARP) {
      const float4 q = __ldg(b4 + v);
      if constexpr (PADDED<W> == W) {
        reinterpret_cast<float4*>(smem)[v] = q;
      } else {
        smem[slot<W>(4 * v)] = q.x;
        smem[slot<W>(4 * v + 1)] = q.y;
        smem[slot<W>(4 * v + 2)] = q.z;
        smem[slot<W>(4 * v + 3)] = q.w;
      }
    }
    done = 4 * vecs;
  }
  for (int f = done + lane; f < total; f += WARP) {
    smem[slot<W>(f)] = __ldg(base + f);
  }
}

// The inverse of stage_in: a warp's rows from shared memory to an (N, W)
// array.
template <int W>
__device__ __forceinline__ void stage_out(float* dst, const float* smem,
                                          long long row0, int rows,
                                          int lane) {
  float* base = dst + row0 * W;
  const int total = rows * W;
  int done = 0;
  if (aligned16(base)) {
    const int vecs = total / 4;
    float4* b4 = reinterpret_cast<float4*>(base);
    for (int v = lane; v < vecs; v += WARP) {
      if constexpr (PADDED<W> == W) {
        b4[v] = reinterpret_cast<const float4*>(smem)[v];
      } else {
        b4[v] = make_float4(smem[slot<W>(4 * v)], smem[slot<W>(4 * v + 1)],
                            smem[slot<W>(4 * v + 2)],
                            smem[slot<W>(4 * v + 3)]);
      }
    }
    done = 4 * vecs;
  }
  for (int f = done + lane; f < total; f += WARP) {
    base[f] = smem[slot<W>(f)];
  }
}

__device__ __forceinline__ float4 load4(const float* p, long long i) {
  if (aligned16(p)) return __ldg(reinterpret_cast<const float4*>(p) + i);
  return make_float4(__ldg(p + 4 * i), __ldg(p + 4 * i + 1),
                     __ldg(p + 4 * i + 2), __ldg(p + 4 * i + 3));
}

// The per-warp shared memory of both kernels, in floats: means, then
// scales or cov6, then colors (when SH is evaluated), then SH rows.
template <int BANDS, bool EVAL, bool COV6>
struct Layout {
  static constexpr int MEANS = 0;
  static constexpr int SECOND = 3 * WARP;
  static constexpr int COLORS = SECOND + (COV6 ? PADDED<6> : 3) * WARP;
  static constexpr int SH = COLORS + (EVAL ? 3 * WARP : 0);
  static constexpr int FLOATS = SH + (BANDS ? PADDED<3 * BANDS> * WARP : 0);
};

// The camera in shared memory: modelview, projection, cutout (row-major
// 4x4 each) and the camera position -R^T t (computed beside the kernel by
// the plain version's own matmul, so both read the same position).
constexpr int CAM_MV = 0, CAM_PR = 16, CAM_CUT = 32, CAM_POS = 48;
constexpr int CAM_FLOATS = 51;

__device__ __forceinline__ void load_camera(float* cam, const float* mv,
                                            const float* pr,
                                            const float* cutout,
                                            const float* campos) {
  const int t = threadIdx.x;
  if (t < 16) {
    cam[CAM_MV + t] = mv[t];
    cam[CAM_PR + t] = pr[t];
    cam[CAM_CUT + t] = cutout ? cutout[t] : 0.0f;
  } else if (t < 19) {
    cam[CAM_POS + t - 16] = campos ? campos[t - 16] : 0.0f;
  }
  __syncthreads();
}

// R(q) row-major, by quat_to_rotmat's bilinear formula
__device__ __forceinline__ void rotmat(float4 q, float* r) {
  const float w = q.x, x = q.y, y = q.z, z = q.w;
  const float xx = mul_rn(x, x), yy = mul_rn(y, y), zz = mul_rn(z, z);
  const float xy = mul_rn(x, y), xz = mul_rn(x, z), yz = mul_rn(y, z);
  const float wx = mul_rn(w, x), wy = mul_rn(w, y), wz = mul_rn(w, z);
  r[0] = sub_rn(1.0f, mul_rn(2.0f, add_rn(yy, zz)));
  r[1] = mul_rn(2.0f, sub_rn(xy, wz));
  r[2] = mul_rn(2.0f, add_rn(xz, wy));
  r[3] = mul_rn(2.0f, add_rn(xy, wz));
  r[4] = sub_rn(1.0f, mul_rn(2.0f, add_rn(xx, zz)));
  r[5] = mul_rn(2.0f, sub_rn(yz, wx));
  r[6] = mul_rn(2.0f, sub_rn(xz, wy));
  r[7] = mul_rn(2.0f, add_rn(yz, wx));
  r[8] = sub_rn(1.0f, mul_rn(2.0f, add_rn(xx, yy)));
}

// M = R diag(s) and the upper triangle (xx, xy, xz, yy, yz, zz) of M M^T,
// as build_covariances sums it on the card
__device__ __forceinline__ void covariance(const float* r, const float* s,
                                           float* m, float* s6) {
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = mul_rn(r[i], s[i % 3]);
  constexpr Sum3 O = Sum3::REDUCE;
  s6[0] = dot3_in<O>(m[0], m[1], m[2], m[0], m[1], m[2]);
  s6[1] = dot3_in<O>(m[0], m[1], m[2], m[3], m[4], m[5]);
  s6[2] = dot3_in<O>(m[0], m[1], m[2], m[6], m[7], m[8]);
  s6[3] = dot3_in<O>(m[3], m[4], m[5], m[3], m[4], m[5]);
  s6[4] = dot3_in<O>(m[3], m[4], m[5], m[6], m[7], m[8]);
  s6[5] = dot3_in<O>(m[6], m[7], m[8], m[6], m[7], m[8]);
}

// amax, propagating NaN as torch does
__device__ __forceinline__ float max_abs6(const float* c) {
  float mx = fabsf(c[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    const float v = fabsf(c[k]);
    mx = mx != mx ? mx : (v != v ? v : fmaxf(mx, v));
  }
  return mx;
}

// The viewer's int16 round trip of s6 in place: q = trunc(c 32767 / max|c|),
// c = q (max|c| / 32767). Keeps the raw triangle, q and max|c|.
__device__ __forceinline__ void viewer_round_trip(float* s6, float* raw,
                                                  float* qf, float& mx) {
  mx = max_abs6(s6);
  const float safe = mx > 0.0f ? mx : 1.0f;
  const float sc = div_rn(mx, 32767.0f);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    raw[k] = s6[k];
    qf[k] = (float)(int)truncf(div_rn(mul_rn(s6[k], 32767.0f), safe));
    s6[k] = mul_rn(qf[k], sc);
  }
}

// The first BANDS real SH basis functions at unit direction (x, y, z), as
// eval_sh writes them
template <int BANDS>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  constexpr float C1 = 0.4886025119029199f;
  b[0] = mul_rn(-C1, y);
  b[1] = mul_rn(C1, z);
  b[2] = mul_rn(-C1, x);
  if constexpr (BANDS > 3) {
    const float xx = mul_rn(x, x), yy = mul_rn(y, y), zz = mul_rn(z, z);
    const float xy = mul_rn(x, y), yz = mul_rn(y, z), xz = mul_rn(x, z);
    b[3] = mul_rn(1.0925484305920792f, xy);
    b[4] = mul_rn(-1.0925484305920792f, yz);
    b[5] = mul_rn(0.31539156525252005f,
                  sub_rn(sub_rn(mul_rn(2.0f, zz), xx), yy));
    b[6] = mul_rn(-1.0925484305920792f, xz);
    b[7] = mul_rn(0.5462742152960396f, sub_rn(xx, yy));
    if constexpr (BANDS > 8) {
      b[8] = mul_rn(mul_rn(-0.5900435899266435f, y),
                    sub_rn(mul_rn(3.0f, xx), yy));
      b[9] = mul_rn(mul_rn(2.890611442640554f, xy), z);
      b[10] = mul_rn(mul_rn(-0.4570457994644658f, y),
                     sub_rn(sub_rn(mul_rn(4.0f, zz), xx), yy));
      b[11] = mul_rn(mul_rn(0.3731763325901154f, z),
                     sub_rn(sub_rn(mul_rn(2.0f, zz), mul_rn(3.0f, xx)),
                            mul_rn(3.0f, yy)));
      b[12] = mul_rn(mul_rn(-0.4570457994644658f, x),
                     sub_rn(sub_rn(mul_rn(4.0f, zz), xx), yy));
      b[13] = mul_rn(mul_rn(1.445305721320277f, z), sub_rn(xx, yy));
      b[14] = mul_rn(mul_rn(-0.5900435899266435f, x),
                     sub_rn(xx, mul_rn(3.0f, yy)));
    }
  }
}

// d(sum_k g_b[k] basis_k) / d(x, y, z)
template <int BANDS>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z,
                                              const float* g_b, float* gd) {
  constexpr float C1 = 0.4886025119029199f;
  float gx = -C1 * g_b[2], gy = -C1 * g_b[0], gz = C1 * g_b[1];
  if constexpr (BANDS > 3) {
    constexpr float A = 1.0925484305920792f, B = 0.31539156525252005f,
                    C = 0.5462742152960396f;
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx += A * y * g_b[3] - 2.0f * B * x * g_b[5] - A * z * g_b[6] +
          2.0f * C * x * g_b[7];
    gy += A * x * g_b[3] - A * z * g_b[4] - 2.0f * B * y * g_b[5] -
          2.0f * C * y * g_b[7];
    gz += -A * y * g_b[4] + 4.0f * B * z * g_b[5] - A * x * g_b[6];
    if constexpr (BANDS > 8) {
      constexpr float D = 0.5900435899266435f, E = 2.890611442640554f,
                      F = 0.4570457994644658f, G = 0.3731763325901154f,
                      H = 1.445305721320277f;
      gx += -6.0f * D * xy * g_b[8] + E * yz * g_b[9] +
            2.0f * F * xy * g_b[10] - 6.0f * G * xz * g_b[11] -
            F * (4.0f * zz - 3.0f * xx - yy) * g_b[12] +
            2.0f * H * xz * g_b[13] - 3.0f * D * (xx - yy) * g_b[14];
      gy += -3.0f * D * (xx - yy) * g_b[8] + E * xz * g_b[9] -
            F * (4.0f * zz - xx - 3.0f * yy) * g_b[10] -
            6.0f * G * yz * g_b[11] + 2.0f * F * xy * g_b[12] -
            2.0f * H * yz * g_b[13] + 6.0f * D * xy * g_b[14];
      gz += E * xy * g_b[9] - 8.0f * F * yz * g_b[10] +
            G * (6.0f * zz - 3.0f * xx - 3.0f * yy) * g_b[11] -
            8.0f * F * xz * g_b[12] + H * (xx - yy) * g_b[13];
    }
  }
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// The view direction of a mean: (m - camera) / max(|m - camera|, 1e-12),
// with the difference v and its norm n kept for the backward; the norm's
// squares summed as torch.linalg.norm sums them on the card
struct ViewDir {
  float v[3], n, nc, d[3];
};

__device__ __forceinline__ ViewDir view_dir(const float* cam, float mx,
                                            float my, float mz) {
  ViewDir r;
  r.v[0] = sub_rn(mx, cam[CAM_POS]);
  r.v[1] = sub_rn(my, cam[CAM_POS + 1]);
  r.v[2] = sub_rn(mz, cam[CAM_POS + 2]);
  r.n = sqrt_rn(dot3_in<Sum3::REDUCE>(r.v[0], r.v[1], r.v[2], r.v[0],
                                      r.v[1], r.v[2]));
  r.nc = max_nan(r.n, 1e-12f);
#pragma unroll
  for (int j = 0; j < 3; ++j) r.d[j] = div_rn(r.v[j], r.nc);
  return r;
}

// eval_sh before its clamp: ((dc - 0.5) + sum_k basis_k sh_k) + 0.5, the
// band sum taken as torch's CUDA reduction over a middle dimension takes
// it (measured on the H100): four partial sums over the bands k = j mod 4,
// then ((s0 + s1) + s2) + s3
template <int BANDS>
__device__ __forceinline__ void sh_color(const float* col, const float* shr,
                                         const float* b, float* pre) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float res = sub_rn(col[c], 0.5f);
    if constexpr (BANDS > 0) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < BANDS; ++k) {
        const float p = mul_rn(b[k], shr[3 * k + c]);
        acc[k % 4] = k < 4 ? p : add_rn(acc[k % 4], p);
      }
      float sum = acc[0];
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        if (j < BANDS) sum = add_rn(sum, acc[j]);
      }
      res = add_rn(res, sum);
    }
    pre[c] = add_rn(res, 0.5f);
  }
}

struct FwdArgs {
  const float* means;       // (N, 3)
  const float* quats;       // (N, 4) w, x, y, z; null with cov6
  const float* scales;      // (N, 3); null with cov6
  const float* cov6;        // (N, 6) upper triangles, or null
  const float* max_scales;  // (N,) with cov6
  const float* colors;      // (N, 3), read when SH is evaluated
  const float* opacities;   // (N,)
  const float* sh;          // (N, BANDS, 3)
  const float* mv;          // (4, 4) row-major, device memory
  const float* pr;          // (4, 4)
  const float* cutout;      // (4, 4) or null
  const float* campos;      // (3,) camera position, read with SH bands
  int n, width, height, viewer_exact, has_eps;
  float log_eps;
  float* mean2d;            // (N, 2)
  float* conic;             // (N, 3)
  float* depth;             // (N,)
  unsigned char* mask;      // (N,) bool
  float* bbox;              // (N, 2)
  float* color;             // (N, 3) when SH is evaluated
};

template <int BANDS, bool EVAL, bool COV6>
__global__ void __launch_bounds__(THREADS)
project_fwd_kernel(const FwdArgs a) {
  using L = Layout<BANDS, EVAL, COV6>;
  __shared__ float cam[CAM_FLOATS];
  __shared__ __align__(16) float smem[WARPS * L::FLOATS];
  load_camera(cam, a.mv, a.pr, a.cutout, a.campos);
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long row0 = ((long long)blockIdx.x * WARPS + warp) * WARP;
  if (row0 >= a.n) return;
  const int rows = (int)min((long long)WARP, a.n - row0);
  const bool live = lane < rows;
  const long long i = row0 + lane;
  float* buf = smem + warp * L::FLOATS;
  stage_in<3>(buf + L::MEANS, a.means, row0, rows, lane);
  if constexpr (COV6) {
    stage_in<6>(buf + L::SECOND, a.cov6, row0, rows, lane);
  } else {
    stage_in<3>(buf + L::SECOND, a.scales, row0, rows, lane);
  }
  if constexpr (EVAL) stage_in<3>(buf + L::COLORS, a.colors, row0, rows, lane);
  if constexpr (BANDS > 0) {
    stage_in<3 * BANDS>(buf + L::SH, a.sh, row0, rows, lane);
  }
  __syncwarp();

  float ca = 0.0f, cb = 0.0f, cc = 0.0f, color[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const float* mrow = buf + L::MEANS + 3 * lane;
    const float mx = mrow[0], my = mrow[1], mz = mrow[2];
    float s6[6], max_scale;
    if constexpr (COV6) {
      const float* crow = buf + L::SECOND + PADDED<6> * lane;
#pragma unroll
      for (int k = 0; k < 6; ++k) s6[k] = crow[k];
      max_scale = __ldg(a.max_scales + i);
    } else {
      const float* srow = buf + L::SECOND + 3 * lane;
      const float s[3] = {srow[0], srow[1], srow[2]};
      float r[9], m[9];
      rotmat(load4(a.quats, i), r);
      covariance(r, s, m, s6);
      if (a.viewer_exact) {
        float raw[6], qf[6], mxq;
        viewer_round_trip(s6, raw, qf, mxq);
      }
      max_scale = s[0];
      max_scale = max_scale != max_scale
                      ? max_scale
                      : (s[1] != s[1] ? s[1] : fmaxf(max_scale, s[1]));
      max_scale = max_scale != max_scale
                      ? max_scale
                      : (s[2] != s[2] ? s[2] : fmaxf(max_scale, s[2]));
    }
    const float opa = __ldg(a.opacities + i);
    const float* mv = cam + CAM_MV;
    const float* pr = cam + CAM_PR;

    const CamPoint p = camera_point(mv, pr, mx, my, mz);
    bool keep = in_frustum(p) && (p.cz < 0.0f) &&
                (mul_rn(max_scale, opa) > mul_rn(SIZE_CULL_THRESHOLD, -p.cz));
    if (a.cutout) {
      const float* cut = cam + CAM_CUT;
      const float qy = -my;  // means * (1, -1, 1)
      float hw = xform(cut, 3, mx, qy, mz);
      hw = fabsf(hw) < 1e-12f ? 1e-12f : hw;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = div_rn(xform(cut, k, mx, qy, mz), hw);
        keep = keep && (v >= -0.5f) && (v <= 0.5f);
      }
    }
    const Ewa e =
        ewa_cov2d<Sum3::REDUCE>(mv, focal_px(pr, a.height), p.cx, p.cy, p.cz,
                                s6[0], s6[1], s6[2], s6[3], s6[4], s6[5]);
    EIGEN_CLAMP(e.a, e.b, e.c, (r2 > 0.0f ? sqrt_rn(r2) : 0.0f));
    ca = conic_a(inv1, inv2, dvx, dvy);
    cb = conic_b(inv1, inv2, dvx, dvy);
    cc = conic_a(inv1, inv2, dvy, dvx);
    const float sw = safe_w(p.w);
    reinterpret_cast<float2*>(a.mean2d)[i] = make_float2(
        to_pixel(p.px, sw, a.width), to_pixel(p.py, sw, a.height));
    a.depth[i] = p.cz;
    a.mask[i] = keep ? 1 : 0;

    // the support box {0.5 d^T conic d <= 4}, shrunk to the opacity-aware
    // support t_eff = min(4, ln(opacity / eps)) when eps is given
    const float cov_xx = add_rn(mul_rn(mul_rn(lam1_raw, dvx), dvx),
                                mul_rn(mul_rn(lam2_eff, dvy), dvy));
    const float cov_yy = add_rn(mul_rn(mul_rn(lam1_raw, dvy), dvy),
                                mul_rn(mul_rn(lam2_eff, dvx), dvx));
    float bx = sqrt_rn(mul_rn(8.0f, max_nan(cov_xx, 0.0f)));
    float by = sqrt_rn(mul_rn(8.0f, max_nan(cov_yy, 0.0f)));
    if (a.has_eps) {
      const float t_eff = min_nan(
          max_nan(sub_rn(logf(max_nan(opa, 1e-30f)), a.log_eps), 0.0f),
          4.0f);
      const float shrink = t_eff > 0.0f ? sqrt_rn(mul_rn(t_eff, 0.25f))
                                        : 0.0f;
      bx = mul_rn(bx, shrink);
      by = mul_rn(by, shrink);
    }
    reinterpret_cast<float2*>(a.bbox)[i] = make_float2(bx, by);

    if constexpr (EVAL) {
      float b[BANDS > 0 ? BANDS : 1];
      if constexpr (BANDS > 0) {
        const ViewDir vd = view_dir(cam, mx, my, mz);
        sh_basis<BANDS>(vd.d[0], vd.d[1], vd.d[2], b);
      }
      float pre[3];
      sh_color<BANDS>(buf + L::COLORS + 3 * lane,
                      buf + L::SH + PADDED<3 * BANDS> * lane, b, pre);
#pragma unroll
      for (int c = 0; c < 3; ++c) color[c] = max_nan(pre[c], 0.0f);
    }
  }
  // every lane has read its rows: the conic and color rows overlay them
  __syncwarp();
  float* out_conic = buf;
  float* out_color = buf + 3 * WARP;
  if (live) {
    out_conic[3 * lane] = ca;
    out_conic[3 * lane + 1] = cb;
    out_conic[3 * lane + 2] = cc;
    if constexpr (EVAL) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out_color[3 * lane + c] = color[c];
    }
  }
  __syncwarp();
  stage_out<3>(a.conic, out_conic, row0, rows, lane);
  if constexpr (EVAL) stage_out<3>(a.color, out_color, row0, rows, lane);
}

struct BwdArgs {
  const float* means;   // (N, 3)
  const float* quats;   // (N, 4)
  const float* scales;  // (N, 3)
  const float* colors;  // (N, 3), read when SH is evaluated
  const float* sh;      // (N, BANDS, 3)
  const float* mv;      // (4, 4) row-major, device memory
  const float* pr;      // (4, 4)
  const float* campos;  // (3,) camera position, read with SH bands
  int n, width, height, viewer_exact;
  // cotangents (null: zero), row i at pointer + i * stride
  const float* g_mean2d;
  long long s_mean2d;
  const float* g_conic;
  long long s_conic;
  const float* g_depth;
  long long s_depth;
  const float* g_color;
  long long s_color;
  float* g_means;   // (N, 3)
  float* g_quats;   // (N, 4)
  float* g_scales;  // (N, 3)
  float* g_colors;  // (N, 3) when SH is evaluated
  float* g_sh;      // (N, BANDS, 3)
};

template <int BANDS, bool EVAL>
__global__ void __launch_bounds__(THREADS)
project_bwd_kernel(const BwdArgs a) {
  using L = Layout<BANDS, EVAL, false>;
  __shared__ float cam[CAM_FLOATS];
  __shared__ __align__(16) float smem[WARPS * L::FLOATS];
  load_camera(cam, a.mv, a.pr, nullptr, a.campos);
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long row0 = ((long long)blockIdx.x * WARPS + warp) * WARP;
  if (row0 >= a.n) return;
  const int rows = (int)min((long long)WARP, a.n - row0);
  const bool live = lane < rows;
  const long long i = row0 + lane;
  float* buf = smem + warp * L::FLOATS;
  stage_in<3>(buf + L::MEANS, a.means, row0, rows, lane);
  stage_in<3>(buf + L::SECOND, a.scales, row0, rows, lane);
  if constexpr (EVAL) stage_in<3>(buf + L::COLORS, a.colors, row0, rows, lane);
  if constexpr (BANDS > 0) {
    stage_in<3 * BANDS>(buf + L::SH, a.sh, row0, rows, lane);
  }
  __syncwarp();

  if (live) {
    float* mrow = buf + L::MEANS + 3 * lane;
    float* srow = buf + L::SECOND + 3 * lane;
    const float mx = mrow[0], my = mrow[1], mz = mrow[2];
    const float s[3] = {srow[0], srow[1], srow[2]};
    const float4 q = load4(a.quats, i);
    const float* mv = cam + CAM_MV;
    const float* pr = cam + CAM_PR;

    // -- the forward, recomputed ----------------------------------------
    float r[9], m[9], s6[6], raw[6], qf[6], mxq = 0.0f;
    rotmat(q, r);
    covariance(r, s, m, s6);
    if (a.viewer_exact) viewer_round_trip(s6, raw, qf, mxq);
    const CamPoint p = camera_point(mv, pr, mx, my, mz);
    const Ewa e =
        ewa_cov2d<Sum3::REDUCE>(mv, focal_px(pr, a.height), p.cx, p.cy, p.cz,
                                s6[0], s6[1], s6[2], s6[3], s6[4], s6[5]);
    EIGEN_CLAMP(e.a, e.b, e.c, (r2 > 0.0f ? sqrt_rn(r2) : 0.0f));
    const float sw = safe_w(p.w);

    float gmx = 0.0f, gmy = 0.0f, g_ca = 0.0f, g_cb = 0.0f, g_cc = 0.0f;
    float g_dep = 0.0f;
    if (a.g_mean2d) {
      const float* gp = a.g_mean2d + i * a.s_mean2d;
      gmx = gp[0];
      gmy = gp[1];
    }
    if (a.g_conic) {
      const float* gp = a.g_conic + i * a.s_conic;
      g_ca = gp[0];
      g_cb = gp[1];
      g_cc = gp[2];
    }
    if (a.g_depth) g_dep = a.g_depth[i * a.s_depth];

    // -- mean2d -----------------------------------------------------------
    const float g_px = gmx * ((float)a.width * 0.5f) / sw;
    const float g_py = gmy * ((float)a.height * 0.5f) / sw;
    const float g_w =
        fabsf(p.w) < 1e-8f ? 0.0f : -(g_px * p.px + g_py * p.py) / sw;

    // -- conic -> (a, b, c) -----------------------------------------------
    const float dxx = dvx * dvx, dyy = dvy * dvy;
    const float dxy = dvx * dvy, dinv = inv1 - inv2;
    const float g_inv1 = g_ca * dxx + g_cb * dxy + g_cc * dyy;
    const float g_inv2 = g_ca * dyy - g_cb * dxy + g_cc * dxx;
    const float g_dvx =
        2.0f * dvx * (g_ca * inv1 + g_cc * inv2) + g_cb * dinv * dvy;
    const float g_dvy =
        2.0f * dvy * (g_ca * inv2 + g_cc * inv1) + g_cb * dinv * dvx;
    const float g_l1e = lam1_raw >= 1e-8f ? -g_inv1 * inv1 * inv1
                                            : 0.0f;
    const float g_l2e = l2e >= 1e-8f ? -g_inv2 * inv2 * inv2 : 0.0f;
    float g_lam1 = s1 <= 1024.0f ? g_l1e * len1 / s1 : 0.0f;
    const float g_lam2 = (s2 <= 1024.0f && lam2 >= 0.0f)
                             ? g_l2e * len2 / s2
                             : 0.0f;
    float g_vx = 0.0f, g_vy = 0.0f;
    if (ok) {
      const float g_vn = -(g_dvx * dvx + g_dvy * dvy) / vn;
      const float g_v2 = g_vn / (2.0f * vn);
      g_vx = g_dvx / vn + 2.0f * vx * g_v2;
      g_vy = g_dvy / vn + 2.0f * vy * g_v2;
    }
    g_lam1 += g_vy;
    const float g_l2r = l2r >= 0.1f ? g_lam2 : 0.0f;
    const float g_mid = g_lam1 + g_l2r, g_rad = g_lam1 - g_l2r;
    const float g_r2 = r2 > 0.0f ? g_rad / (2.0f * radius) : 0.0f;
    const float g_hh = 2.0f * hh * g_r2;
    const float g_a = 0.5f * g_mid + 0.5f * g_hh - g_vy;
    const float g_b = g_vx + 2.0f * e.b * g_r2;
    const float g_c = 0.5f * g_mid - 0.5f * g_hh;

    // -- (a, b, c) -> T and the covariance --------------------------------
    const float sig[9] = {s6[0], s6[1], s6[2], s6[1], s6[3],
                          s6[4], s6[2], s6[4], s6[5]};
    float g_u0[3], g_u1[3], g_t0[3], g_t1[3], g_sig[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_u0[j] = g_a * e.t0[j] + g_b * e.t1[j];
      g_u1[j] = g_c * e.t1[j];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_t0[j] = g_a * e.u0[j] + (sig[j] * g_u0[0] + sig[3 + j] * g_u0[1] +
                                 sig[6 + j] * g_u0[2]);
      g_t1[j] = g_b * e.u0[j] + g_c * e.u1[j] +
                (sig[j] * g_u1[0] + sig[3 + j] * g_u1[1] +
                 sig[6 + j] * g_u1[2]);
    }
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        g_sig[3 * ii + j] = g_u0[ii] * e.t0[j] + g_u1[ii] * e.t1[j];
      }
    }

    // -- T -> camera space -> means --------------------------------------
    const float g_fz = (g_t0[0] * mv[0] + g_t0[1] * mv[1] + g_t0[2] * mv[2]) -
                       (g_t1[0] * mv[4] + g_t1[1] * mv[5] + g_t1[2] * mv[6]);
    const float g_cxf =
        -(g_t0[0] * mv[8] + g_t0[1] * mv[9] + g_t0[2] * mv[10]);
    const float g_cyf = g_t1[0] * mv[8] + g_t1[1] * mv[9] + g_t1[2] * mv[10];
    const float g_fz2 = g_cxf * p.cx + g_cyf * p.cy;
    const float g_sz = -g_fz * e.fz / e.sz - 2.0f * g_fz2 * e.fz2 / e.sz;
    float g_cam[3] = {g_cxf * e.fz2, g_cyf * e.fz2,
                      (fabsf(p.cz) < 1e-8f ? 0.0f : g_sz) + g_dep};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_cam[j] += g_px * pr[j] + g_py * pr[4 + j] + g_w * pr[12 + j];
    }
    float g_m[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_m[j] = g_cam[0] * mv[j] + g_cam[1] * mv[4 + j] + g_cam[2] * mv[8 + j];
    }

    // -- SH ---------------------------------------------------------------
    if constexpr (EVAL) {
      float* crow = buf + L::COLORS + 3 * lane;
      float* shrow = buf + L::SH + PADDED<3 * BANDS> * lane;
      float b[BANDS > 0 ? BANDS : 1];
      ViewDir vd;
      if constexpr (BANDS > 0) {
        vd = view_dir(cam, mx, my, mz);
        sh_basis<BANDS>(vd.d[0], vd.d[1], vd.d[2], b);
      }
      float pre[3], g_pre[3];
      sh_color<BANDS>(crow, shrow, b, pre);
      const float* gp = a.g_color + i * a.s_color;
#pragma unroll
      for (int c = 0; c < 3; ++c) g_pre[c] = pre[c] >= 0.0f ? gp[c] : 0.0f;
      if constexpr (BANDS > 0) {
        float g_b[BANDS];
#pragma unroll
        for (int k = 0; k < BANDS; ++k) {
          g_b[k] = g_pre[0] * shrow[3 * k] + g_pre[1] * shrow[3 * k + 1] +
                   g_pre[2] * shrow[3 * k + 2];
#pragma unroll
          for (int c = 0; c < 3; ++c) shrow[3 * k + c] = g_pre[c] * b[k];
        }
        float g_d[3];
        sh_basis_grad<BANDS>(vd.d[0], vd.d[1], vd.d[2], g_b, g_d);
        const float g_nc =
            -(g_d[0] * vd.d[0] + g_d[1] * vd.d[1] + g_d[2] * vd.d[2]) / vd.nc;
        const float g_n = vd.n >= 1e-12f ? g_nc / vd.n : 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) g_m[j] += g_d[j] / vd.nc + g_n * vd.v[j];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) crow[c] = g_pre[c];
    }

    // -- covariance -> M = R diag(s) -> quats, scales --------------------
    float gs[9];
    if (a.viewer_exact) {
      const float g6[6] = {g_sig[0], g_sig[1] + g_sig[3], g_sig[2] + g_sig[6],
                           g_sig[4], g_sig[5] + g_sig[7], g_sig[8]};
      float g_mx = 0.0f;
      int ties = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        g_mx += g6[k] * qf[k];
        ties += fabsf(raw[k]) == mxq;
      }
      const float share = g_mx / 32767.0f / (float)ties;
      float gc6[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float sgn = (float)((raw[k] > 0.0f) - (raw[k] < 0.0f));
        gc6[k] = fabsf(raw[k]) == mxq ? share * sgn : 0.0f;
      }
      const float up[9] = {2.0f * gc6[0], gc6[1], gc6[2],
                           gc6[1], 2.0f * gc6[3], gc6[4],
                           gc6[2], gc6[4], 2.0f * gc6[5]};
#pragma unroll
      for (int k = 0; k < 9; ++k) gs[k] = up[k];
    } else {
#pragma unroll
      for (int ii = 0; ii < 3; ++ii) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          gs[3 * ii + j] = g_sig[3 * ii + j] + g_sig[3 * j + ii];
        }
      }
    }
    float gm[9], gr[9], g_s[3];
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gm[3 * ii + k] = gs[3 * ii] * m[k] + gs[3 * ii + 1] * m[3 + k] +
                         gs[3 * ii + 2] * m[6 + k];
        gr[3 * ii + k] = gm[3 * ii + k] * s[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_s[k] = gm[k] * r[k] + gm[3 + k] * r[3 + k] + gm[6 + k] * r[6 + k];
    }
    const float w = q.x, x = q.y, y = q.z, z = q.w;
    const float4 g_q = make_float4(
        2.0f * (-z * gr[1] + y * gr[2] + z * gr[3] - x * gr[5] - y * gr[6] +
                x * gr[7]),
        2.0f * (y * gr[1] + z * gr[2] + y * gr[3] - 2.0f * x * gr[4] -
                w * gr[5] + z * gr[6] + w * gr[7] - 2.0f * x * gr[8]),
        2.0f * (-2.0f * y * gr[0] + x * gr[1] + w * gr[2] + x * gr[3] +
                z * gr[5] - w * gr[6] + z * gr[7] - 2.0f * y * gr[8]),
        2.0f * (-2.0f * z * gr[0] - w * gr[1] + x * gr[2] + w * gr[3] -
                2.0f * z * gr[4] + y * gr[5] + x * gr[6] + y * gr[7]));
    reinterpret_cast<float4*>(a.g_quats)[i] = g_q;
    // each lane overwrites its own rows only
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      mrow[j] = g_m[j];
      srow[j] = g_s[j];
    }
  }
  __syncwarp();
  stage_out<3>(a.g_means, buf + L::MEANS, row0, rows, lane);
  stage_out<3>(a.g_scales, buf + L::SECOND, row0, rows, lane);
  if constexpr (EVAL) {
    stage_out<3>(a.g_colors, buf + L::COLORS, row0, rows, lane);
  }
  if constexpr (BANDS > 0) {
    stage_out<3 * BANDS>(a.g_sh, buf + L::SH, row0, rows, lane);
  }
}

unsigned blocks_for(int n) {
  return (unsigned)(((long long)n + THREADS - 1) / THREADS);
}

template <int BANDS, bool EVAL, bool COV6>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  project_fwd_kernel<BANDS, EVAL, COV6>
      <<<blocks_for(a.n), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool COV6>
int fwd_by_bands(const FwdArgs& a, int bands, int sh_eval,
                 cudaStream_t stream) {
  if (!sh_eval) {
    return bands == 0 ? launch_fwd<0, false, COV6>(a, stream)
                      : (int)cudaErrorInvalidValue;
  }
  switch (bands) {
    case 0: return launch_fwd<0, true, COV6>(a, stream);
    case 3: return launch_fwd<3, true, COV6>(a, stream);
    case 8: return launch_fwd<8, true, COV6>(a, stream);
    case 15: return launch_fwd<15, true, COV6>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int BANDS, bool EVAL>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  project_bwd_kernel<BANDS, EVAL><<<blocks_for(a.n), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward. means, colors, opacities: (N, 3), (N, 3), (N,) f32; either
// quats (N, 4) and scales (N, 3), or cov6 (N, 6) upper triangles with
// max_scales (N,) (the other pair null). sh: (N, bands, 3) with bands 0,
// 3, 8 or 15, evaluated (and colors read) when sh_eval; mv, pr, cutout:
// device pointers to row-major 4x4 f32 (cutout may be null); campos: the
// camera position (3,) in device memory, read when bands > 0; viewer_exact:
// the int16 round trip of covariances built from quats/scales; has_eps,
// log_eps: the support boxes shrink to min(4, ln(opacity) - log_eps).
// Outputs: mean2d (N, 2), conic (N, 3), depth (N,), mask (N,) bool bytes,
// bbox (N, 2), color (N, 3) when sh_eval. Returns the launch's error;
// another band count returns cudaErrorInvalidValue and launches nothing.
extern "C" int splat_project_fwd(
    const float* means, const float* quats, const float* scales,
    const float* cov6, const float* max_scales, const float* colors,
    const float* opacities, const float* sh, int bands, int sh_eval,
    const float* mv, const float* pr, const float* cutout,
    const float* campos, int n, int width, int height, int viewer_exact,
    int has_eps, float log_eps, float* mean2d, float* conic, float* depth,
    unsigned char* mask, float* bbox, float* color, cudaStream_t stream) {
  if (n == 0) return 0;
  const FwdArgs a{means,  quats,   scales,  cov6,   max_scales, colors,
                  opacities, sh,   mv,      pr,     cutout,     campos,
                  n,      width,   height,  viewer_exact, has_eps, log_eps,
                  mean2d, conic,   depth,   mask,   bbox,       color};
  return cov6 ? fwd_by_bands<true>(a, bands, sh_eval, stream)
              : fwd_by_bands<false>(a, bands, sh_eval, stream);
}

// Backward of the quats/scales form. The inputs as the forward's (campos
// read when sh_eval and bands > 0); the
// cotangents of mean2d, conic, depth and (when sh_eval) color, each null
// (zero) or rows at a row stride in floats; outputs g_means (N, 3),
// g_quats (N, 4), g_scales (N, 3) and, when sh_eval, g_colors (N, 3) and
// g_sh (N, bands, 3). Without sh_eval the SH is not read and gives no
// gradient to the means.
extern "C" int splat_project_bwd(
    const float* means, const float* quats, const float* scales,
    const float* colors, const float* sh, int bands, int sh_eval,
    const float* mv, const float* pr, const float* campos, int n, int width,
    int height, int viewer_exact, const float* g_mean2d, long long s_mean2d,
    const float* g_conic, long long s_conic, const float* g_depth,
    long long s_depth, const float* g_color, long long s_color,
    float* g_means, float* g_quats, float* g_scales, float* g_colors,
    float* g_sh, cudaStream_t stream) {
  if (n == 0) return 0;
  const BwdArgs a{means,   quats,    scales,  colors,   sh,
                  mv,      pr,       campos,  n,        width,
                  height,  viewer_exact, g_mean2d, s_mean2d, g_conic, s_conic,
                  g_depth, s_depth,  g_color, s_color,  g_means,
                  g_quats, g_scales, g_colors, g_sh};
  if (!sh_eval) return launch_bwd<0, false>(a, stream);
  switch (bands) {
    case 0: return launch_bwd<0, true>(a, stream);
    case 3: return launch_bwd<3, true>(a, stream);
    case 8: return launch_bwd<8, true>(a, stream);
    case 15: return launch_bwd<15, true>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
