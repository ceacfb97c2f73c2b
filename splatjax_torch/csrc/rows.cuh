// Packed instance rows shared by the forward (K2) and backward (K4)
// rasterizers: decode of one 8-lane int32 row, in splatjax's 32-byte viewer
// layout or its 16-byte training layout (splatjax/ops/rasterize.py
// unpack_chunk / unpack_chunk16), to f32 features.
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

}  // namespace
