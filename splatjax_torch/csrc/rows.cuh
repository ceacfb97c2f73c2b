// Packed instance rows shared by the forward (K2) and backward (K4)
// rasterizers: decode of one 8-lane int32 row, in splatjax's 32-byte viewer
// layout or its 16-byte training layout (splatjax/ops/rasterize.py
// unpack_chunk / unpack_chunk16), to f32 features; and the two records of
// an instance's power polynomial that every fragment loop (K2, K3, K4)
// keeps in shared memory and evaluates at a thread's pixels.
#pragma once

#include <cuda_runtime.h>

namespace {

struct Decoded {
  float mx, my, ca, cb, cc, r, g, b, opa, depth;
};

// One packed row (two 16-byte loads) -> f32 features.
template <bool PACKED16>
__device__ __forceinline__ Decoded decode_row(const int4* __restrict__ rows,
                                              long long k) {
  const int4 a = __ldg(rows + 2 * k);
  const int4 b = __ldg(rows + 2 * k + 1);
  Decoded d;
  if (PACKED16) {
    const unsigned l0 = (unsigned)a.x, l1 = (unsigned)a.y;
    const unsigned l2 = (unsigned)a.z, l3 = (unsigned)a.w;
    d.mx = (float)(l0 >> 16) * 0.125f - 2048.0f;
    d.my = (float)(l0 & 0xFFFFu) * 0.125f - 2048.0f;
    d.ca = __uint_as_float(l1 & 0xFFFF0000u);
    d.cb = __uint_as_float(l1 << 16);
    d.cc = __uint_as_float(l2 & 0xFFFF0000u);
    d.opa = (float)(l2 & 0xFFFFu) * (1.0f / 65535.0f);
    const float inv255 = 1.0f / 255.0f;
    d.r = (float)(l3 >> 24) * inv255;
    d.g = (float)((l3 >> 16) & 0xFFu) * inv255;
    d.b = (float)((l3 >> 8) & 0xFFu) * inv255;
    d.depth = __int_as_float(b.x);
  } else {
    const float inv = 1.0f / 65535.0f;
    const unsigned rg = (unsigned)b.y, bo = (unsigned)b.z;
    d.mx = __int_as_float(a.x);
    d.my = __int_as_float(a.y);
    d.ca = __int_as_float(a.z);
    d.cb = __int_as_float(a.w);
    d.cc = __int_as_float(b.x);
    d.r = (float)(rg >> 16) * inv;
    d.g = (float)(rg & 0xFFFFu) * inv;
    d.b = (float)(bo >> 16) * inv;
    d.opa = (float)(bo & 0xFFFFu) * inv;
    d.depth = __int_as_float(b.w);
  }
  return d;
}

// f32 operations rounded one by one, which nvcc never contracts into an
// FMA: the order and rounding of the plain PyTorch versions.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// Whether a rasterizer at tile edge TILE evaluates the power polynomial op
// by op (EXACT below). At 16 px nvcc's FMA contraction keeps the kernels
// within 1e-4 of their plain versions; wider tiles put pixels up to 31.5
// px from the tile centre, the polynomial's terms grow with that offset,
// and a contracted power then lands across the exp(-4) cutoff from the
// plain version's often enough to fail that check on an H100.
template <int TILE>
struct ExactPower {
  static constexpr bool value = TILE > 16;
};

// Instance d's power polynomial in tile-centred coordinates, (mxl, myl) =
// its mean minus the tile centre: pw = (c0, c1, c2, c3), ct = (c4, c5,
// log-alpha threshold, depth), with log alpha = c0 + c1 x + c2 y + c3 x^2
// + c4 xy + c5 y^2 (splatjax's coefficient formulation). EXACT: each
// operation rounded on its own, in the plain version's order.
template <bool EXACT>
__device__ __forceinline__ void power_records(const Decoded& d, float mxl,
                                              float myl, float4& pw,
                                              float4& ct) {
  const float ca = d.ca, cb = d.cb, cc = d.cc;
  const float lnopa = logf(fmaxf(d.opa, 1e-30f));
  if constexpr (EXACT) {
    const float q = add_rn(mul_rn(mul_rn(ca, mxl), mxl),
                           mul_rn(mul_rn(cc, myl), myl));
    pw = make_float4(
        add_rn(sub_rn(mul_rn(-0.5f, q), mul_rn(mul_rn(cb, mxl), myl)),
               lnopa),
        add_rn(mul_rn(ca, mxl), mul_rn(cb, myl)),
        add_rn(mul_rn(cc, myl), mul_rn(cb, mxl)), -0.5f * ca);
  } else {
    pw = make_float4(
        -0.5f * (ca * mxl * mxl + cc * myl * myl) - cb * mxl * myl + lnopa,
        ca * mxl + cb * myl, cc * myl + cb * mxl, -0.5f * ca);
  }
  ct = make_float4(-cb, -0.5f * cc, lnopa - 4.0f, d.depth);
}

// The sub-blocks of a TILE x TILE tile (SUB_W x SUB_H each, numbered row
// by row, TILE / SUB_W to a row) that instance d's support can reach: bit b
// is clear only if no pixel of sub-block b can pass the exp(-4) cutoff, so
// a block may skip the instances whose bit is clear and leave every sum
// bit-equal. (mxl, myl): its mean minus the tile centre, lnopa: its log
// opacity, as power_records<true> takes and computes them.
//
// The rectangle is ops/rasterize.py's support_rect, op for op (f32, each
// operation rounded on its own). The power evaluated op by op
// (power_records<true>, eval_power<true>) is within 10 ulps x T of the
// exact polynomial, T the sum of |each term| at |x|, |y| <= TILE / 2, so a
// hit has q = ca dx^2 + 2 cb dx dy + cc dy^2 below Q = 8 + 2^-16 (T + 4),
// and lies within sqrt(Q cc / det), sqrt(Q ca / det) of the mean, det =
// ca cc - cb^2, bounded below by its rounded value less 2^-20 (ca cc +
// cb^2); the half-widths are raised by 2^-20 of themselves and one pixel,
// far more than the rounding of each step. Not positive definite (or NaN):
// every bit.
template <int TILE, int SUB_W, int SUB_H>
__device__ __forceinline__ unsigned support_mask(const Decoded& d, float mxl,
                                                 float myl, float lnopa) {
  constexpr int COLS = TILE / SUB_W, ROWS = TILE / SUB_H;
  constexpr unsigned ALL = (1u << (COLS * ROWS)) - 1u;
  constexpr float H = 0.5f * TILE;
  const float ca = d.ca, cb = d.cb, cc = d.cc;
  const float aa = fabsf(ca), ab = fabsf(cb), ac = fabsf(cc);
  const float amx = fabsf(mxl), amy = fabsf(myl);
  float t = add_rn(fabsf(lnopa), mul_rn(mul_rn(0.5f, aa), mul_rn(amx, amx)));
  t = add_rn(t, mul_rn(mul_rn(0.5f, ac), mul_rn(amy, amy)));
  t = add_rn(t, mul_rn(ab, mul_rn(amx, amy)));
  t = add_rn(t, mul_rn(H, add_rn(add_rn(mul_rn(aa, amx), mul_rn(ab, amy)),
                                 add_rn(mul_rn(ac, amy), mul_rn(ab, amx)))));
  t = add_rn(t, mul_rn(H * H, add_rn(add_rn(mul_rn(0.5f, aa), ab),
                                     mul_rn(0.5f, ac))));
  const float q = add_rn(8.0f, mul_rn(0x1p-16f, add_rn(t, 4.0f)));
  const float p1 = mul_rn(ca, cc), p2 = mul_rn(cb, cb);
  const float det = sub_rn(sub_rn(p1, p2), mul_rn(0x1p-20f, add_rn(p1, p2)));
  if (!(ca > 0.0f && det > 0.0f)) return ALL;
  const float grow = 1.0f + 0x1p-20f;
  const float hx = add_rn(
      mul_rn(__fsqrt_rn(__fdiv_rn(mul_rn(q, cc), det)), grow), 1.0f);
  const float hy = add_rn(
      mul_rn(__fsqrt_rn(__fdiv_rn(mul_rn(q, ca), det)), grow), 1.0f);
  const float x0 = sub_rn(mxl, hx), x1 = add_rn(mxl, hx);
  const float y0 = sub_rn(myl, hy), y1 = add_rn(myl, hy);
  // pixel centres of sub-block column i: [i SUB_W - H + 0.5, ... + SUB_W - 1]
  unsigned cols = 0, mask = 0;
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    const float lo = i * SUB_W - H + 0.5f, hi = lo + (SUB_W - 1);
    if (!(x0 > hi || x1 < lo)) cols |= 1u << i;
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float lo = j * SUB_H - H + 0.5f, hi = lo + (SUB_H - 1);
    if (!(y0 > hi || y1 < lo)) mask |= cols << (j * COLS);
  }
  return mask;
}

// An instance's log alpha before the clip at a thread's N pixels (x, y[j])
// from its records, term for term in this order: another association or
// FMA contraction flips fragments on the exp(-4) cutoff (EXACT: no
// contraction). hit[j]: inside the support and in front of the z-buffer.
// Returns whether any is hit.
template <bool EXACT, int N>
__device__ __forceinline__ bool eval_power(const float4 pw, const float4 ct,
                                           float x, float xx,
                                           const float (&y)[N],
                                           const float (&xy)[N],
                                           const float (&yy)[N],
                                           const float (&zb)[N],
                                           float (&power)[N], bool (&hit)[N]) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (EXACT) {
      float p = add_rn(pw.x, mul_rn(pw.y, x));
      p = add_rn(p, mul_rn(pw.z, y[j]));
      p = add_rn(p, mul_rn(pw.w, xx));
      p = add_rn(p, mul_rn(ct.x, xy[j]));
      power[j] = add_rn(p, mul_rn(ct.y, yy[j]));
    } else {
      power[j] = pw.x + pw.y * x + pw.z * y[j] + pw.w * xx + ct.x * xy[j] +
                 ct.y * yy[j];
    }
    hit[j] = power[j] >= ct.z && ct.w > zb[j];
    any |= hit[j];
  }
  return any;
}

}  // namespace
