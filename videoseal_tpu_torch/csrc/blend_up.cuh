// What K1 (fused_planar.cu) and K4 (jnd_up.cu) share: the thread layout, the
// prediction's upsample from staged low-res rows, the rolling luminance
// window, and byte packing.
//
// Layout. One thread owns G = 16 consecutive columns of a row and walks the
// RS rows of its block's strip; a block holds up to MAX_NT threads side by
// side, a band of up to 4096 columns (one band covers a 4K frame). So a u8
// plane row of 16 columns is one 16-byte load and one 16-byte store, and 16
// NHWC u8 pixels are three.
//
// The upsample. The wrapper passes the low-res prediction pred_low (F, s, s)
// f32 itself, not a width-resized copy: the block stages the few low-res
// rows its strip lifts from (s floats each) in shared memory, and each
// thread forms the prediction at its columns from there, with its columns'
// width taps in registers: width taps first, then the height lift, in the
// plain version's order (its dense products in another order), each product
// and sum rounded on its own.
//
// The rolling window. For the full-resolution JND the block keeps the
// luminance of five rows (y - 2 .. y + 2) of its band plus a two-column halo
// on each side, row gy in slot gy mod 5. Each step computes one new row from
// the frame, whose loads were issued a step ahead, and drops the oldest, so
// each input row of the strip (and of its 4-row halo) is read from the frame
// once per block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "jnd_heat.cuh"

namespace blend_up {

constexpr int G = 16;         // columns a thread owns
constexpr int MAX_NT = 256;   // threads per block at most

// The width taps of a thread's G columns. WT > 0: the start and WT weights
// of each column's band of _resize_matrix(s, W), in registers (the wrapper
// pads a narrower band with zero weights, which add exact zeros). WT == 0:
// any number of taps, read from the tables at each use.
template <int WT>
struct WidthTaps {
  int st[G];
  float w[G][WT];
  __device__ __forceinline__ void load(const int* __restrict__ ws, const float* __restrict__ ww,
                                       int, int x0, int ncols) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int x = min(x0 + i, ncols - 1);   // a ragged group repeats its last column
      st[i] = ws[x];
#pragma unroll
      for (int t = 0; t < WT; ++t) w[i][t] = ww[(size_t)x * WT + t];
    }
  }
  __device__ __forceinline__ float tmp(int i, const float* __restrict__ row) const {
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < WT; ++u) v = __fadd_rn(v, __fmul_rn(w[i][u], row[st[i] + u]));
    return v;
  }
};

template <>
struct WidthTaps<0> {
  const int* ws;
  const float* ww;
  int wt, x0, ncols;
  __device__ __forceinline__ void load(const int* __restrict__ ws_, const float* __restrict__ ww_,
                                       int wt_, int x0_, int ncols_) {
    ws = ws_, ww = ww_, wt = wt_, x0 = x0_, ncols = ncols_;
  }
  __device__ __forceinline__ float tmp(int i, const float* __restrict__ row) const {
    const int x = min(x0 + i, ncols - 1);
    const float* w = ww + (size_t)x * wt;
    const float* r = row + ws[x];
    float v = 0.f;
    for (int u = 0; u < wt; ++u) v = __fadd_rn(v, __fmul_rn(w[u], r[u]));
    return v;
  }
};

// Rows [rlo, rlo + nl) of one frame's (s, s) prediction into shared memory;
// pl points at row rlo.
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const float* __restrict__ pl,
                                           int nl, int s) {
  for (int i = threadIdx.x; i < nl * s; i += blockDim.x) dst[i] = pl[i];
}

// The upsampled prediction at the thread's G columns of one output row:
// p[i] = sum_t lw[t] * tmp(t, i), tmp(t, i) the width taps over the staged
// row `rows + t * s` (the first row the output row lifts from).
template <int WT>
__device__ __forceinline__ void pred_up(float (&p)[G], const WidthTaps<WT>& wt,
                                        const float* __restrict__ rows, int s,
                                        const float* __restrict__ lw, int lt) {
#pragma unroll
  for (int i = 0; i < G; ++i) p[i] = 0.f;
  for (int t = 0; t < lt; ++t) {
    const float* row = rows + (size_t)t * s;
    const float wl = lw[t];
#pragma unroll
    for (int i = 0; i < G; ++i) p[i] = __fadd_rn(p[i], __fmul_rn(wl, wt.tmp(i, row)));
  }
}

// Slot of image row gy (gy >= -2) in the five-row window.
__device__ __forceinline__ float* ring_row(float* ring, int gy, int ld) {
  return ring + ((gy + 5) % 5) * ld;
}

// Window geometry: a row holds the band's columns -4 .. nt * G + 3, band
// column x at window column x + 4, so that a thread's own G columns start at
// a 16-byte boundary (4 + 16 * tid) for its stores, and its stencil's
// columns x - 2 .. x + G + 1 lie in the 16-byte words from window column
// 16 * tid to 16 * tid + G + 8.
// In shared memory a window row is padded by 4 floats after every 32, so
// that the 16-byte accesses of 8 threads 16 columns apart (a quarter warp)
// fall on distinct banks: window column c is at wcol(c). Aligned 4-column
// words never straddle a pad.
constexpr int PADL = 4;
__host__ __device__ __forceinline__ int wcol(int c) { return c + 4 * (c >> 5); }
__host__ __device__ __forceinline__ int window_ld(int nt) { return wcol(nt * G + 2 * PADL) + 4; }

// The JND heat of the thread's G columns of row y; w0 = 16 * tid, the
// window column of the thread's first column minus PADL. In two halves of
// 8 pixels: each of a half's 12 window columns' vertical sums is formed once
// (from 16-byte loads), then each pixel's horizontal ones: the same
// additions, in the same order, as jnd_heat_rows, which forms the vertical
// sums anew for every pixel.
template <int HM = kHeatNoSqrt>
__device__ __forceinline__ void heat_row(float (&heat)[G], float* ring, int y, int ld, int w0) {
  const float* r[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) r[k] = ring_row(ring, y - 2 + k, ld);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int hb = 8 * half;
    float q[5][16];   // window columns w0 + hb .. w0 + hb + 15
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(r[k] + wcol(w0 + hb + j));
        q[k][j] = v.x, q[k][j + 1] = v.y, q[k][j + 2] = v.z, q[k][j + 3] = v.w;
      }
    // column m of the half's stencil (m = 0..11) is window column w0 + hb + 2 + m
    float v5[12], v3[12], t[12], sd[12], ce[12];
#pragma unroll
    for (int m = 0; m < 12; ++m) {
      const int u = m + 2;
      v5[m] = (((q[0][u] + q[1][u]) + q[2][u]) + q[3][u]) + q[4][u];
      v3[m] = (q[1][u] + q[2][u]) + q[3][u];
      t[m] = __fadd_rn(q[1][u] + 2.f * q[2][u], q[3][u]);
      sd[m] = q[1][u] - q[3][u];
      ce[m] = q[2][u];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float c5 = (((v5[i] + v5[i + 1]) + v5[i + 2]) + v5[i + 3]) + v5[i + 4];
      const float c3 = (v3[i + 1] + v3[i + 2]) + v3[i + 3];
      const float gy = __fadd_rn(sd[i + 1] + 2.f * sd[i + 2], sd[i + 3]);
      if constexpr (HM == kHeatCopy)   // K1's attribution: the window, no stencil
        heat[hb + i] = ce[i + 2];
      else
        heat[hb + i] = jnd_heat_sums<HM>(c5, c3, ce[i + 2], t[i + 1], t[i + 3], gy);
    }
  }
}

// Luminance on the 0..255 scale, the plain version's order.
__device__ __forceinline__ float lum(float c0, float c1, float c2, float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, r), __fmul_rn(c1, g)), __fmul_rn(c2, b));
}

// Byte k of 16-byte words held as 32-bit words.
__device__ __forceinline__ float byte_at(const uint32_t* wd, int k) {
  return (float)((wd[k >> 2] >> (8 * (k & 3))) & 0xffu);
}

// clip(round half to even(v), 0, 255) into byte k of `wd` (zeroed first).
__device__ __forceinline__ void put_byte(uint32_t* wd, int k, float v) {
  const uint32_t q = (uint32_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
  wd[k >> 2] |= q << (8 * (k & 3));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

}  // namespace blend_up
