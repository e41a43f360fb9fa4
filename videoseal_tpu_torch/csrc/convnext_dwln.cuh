// The ConvNeXtV2 block's first part, dwln, as a device function: the
// depthwise 7x7 conv, its bias and the channel LayerNorm over one image row
// of one frame, NHWC. K2 (convnext_dwln.cu) calls it once per block of a
// (row, frame) grid, K3 (convnext_group.cuh) once per item of its dwln
// phase, the K8 probe (convnext_probe.cu) in its templated forms.
//
// K2 replaces videoseal_tpu/kernels/convnext_block.py::convnext_block_fused
// (Pallas body _block_math); this part is its dw + LN prologue.
//
// x (B, H, W, C), f32 or bf16, is read directly: the 3-pixel halo outside
// the frame is zero (no padded copy). Out: A (B*H*W, C) bf16, row-major, the
// LN output rounded to bf16, which pw1 reads as its A operand.
//
// Bound on the H100: bytes (x read once, A written once; 49 multiply-adds
// per output, far below the f32 rate). Design: one (frame, image row) per
// item, no barrier inside the depthwise phase. A thread takes one
// channel of an 8-pixel row segment: for each of the 7 rows of taps it loads
// the 14 inputs the segment needs (through L1, where the neighbouring
// segments' and rows' loads land too; a warp reads 32 consecutive channels;
// only segments at the frame's edge test each pixel) and its 7 taps, and
// sums the 8 outputs in the per-dy order of the plain version
// (dw_plain(form="perdy")) with the products fused into the row sums (FMA,
// as the earlier kernel did; the plain version rounds each product), then
// adds the bias. The f32 results of the row, all C channels, wait in
// shared memory; then one warp per pixel takes the LN's mean and variance
// (two passes over the row) and writes two channels per lane and step as
// bf16 pairs. Timed on the H100 and not kept: 16-channel slices staged in
// shared memory with a barrier per slice (latency-bound at the small-W
// stages), the taps staged in shared memory, two channels a thread, 4- or
// 16-pixel segments, and two or four rows a block.
//
// The K8 probe's switches, compiled away in K2's and K3's instance: the
// depthwise form (DwForm), a padded input whose 3-pixel halo is data (PAD),
// and a depthwise-only mode (DWONLY) that writes the bf16 sum without its
// bias and stops.

#pragma once

#include "gemm_tn.cuh"

namespace cnx {

using gemm::bf16;
using gemm::NT;
constexpr int SEG = 8;  // outputs along a row per thread

// the depthwise sum's order: K2's per-row partials (dw_plain "perdy"), and
// the probe's one chain with dy outer ("taps"), one chain with dx outer
// ("shift"), bf16 products and sums ("bf16")
enum DwForm { kDwPerDy = 0, kDwTaps = 1, kDwShift = 2, kDwBf16 = 3 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// (v - mu) * rs * w + b, each step rounded as in the plain version
__device__ __forceinline__ float ln(float v, float mu, float rs, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rs), w), b);
}

// bf16(s + bf16(x * w)), each step rounded in bf16 (_rn: no FMA)
__device__ __forceinline__ float bf16_tap(float s, float x, float w) {
  return __bfloat162float(__hadd_rn(__float2bfloat16(s),
                                    __hmul_rn(__float2bfloat16(x), __float2bfloat16(w))));
}

// dwln of image row y of frame f: A's rows (f, y, 0 .. W-1). acc: W x C
// floats of shared memory (the row's depthwise output + bias). x: (B, H, W,
// C) in T with a zero halo; PAD: (B, H+6, W+6, C) whose halo is read.
// DWONLY: a is the (B, H, W, C) bf16 depthwise sum without its bias.
// TRUEC: C is a width padded with zero channels (zero taps, bias and LN
// affine) past the true width Ct, and the LN's mean and variance are taken
// over the Ct true channels; the pads stay 0. Without it Ct is not read and
// the instance compiles as it did before the pads.
template <typename T, int DW = kDwPerDy, bool PAD = false, bool DWONLY = false,
          bool TRUEC = false>
__device__ __forceinline__ void dwln_row(float* __restrict__ acc, const T* __restrict__ x,
                                         const float* __restrict__ dw,
                                         const float* __restrict__ dwb,
                                         const float* __restrict__ lnw,
                                         const float* __restrict__ lnb, bf16* __restrict__ a,
                                         int H, int W, int C, int f, int y,
                                         int Ct = 0) {
  constexpr int HALO = PAD ? 3 : 0;  // pixels of x outside the frame, each side
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nseg = (W + SEG - 1) / SEG, ld = W + 2 * HALO;
  // pixel (0, 0) of frame f
  const T* xf = x + ((size_t)f * (H + 2 * HALO) + HALO) * ld * C + HALO * C;

  // depthwise 7x7 + bias: items (segment, channel), channel fastest
  for (int it = tid; it < nseg * C; it += NT) {
    const int c = it % C, x0 = (it / C) * SEG;
    // interior segments load without per-pixel tests; rows outside x add
    // nothing
    const bool inner = x0 >= 3 - HALO && x0 + SEG + 3 <= W + HALO;
    float sum[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) sum[j] = 0.f;
    if constexpr (DW == kDwShift) {
      // dx outer: the tap's 8 inputs straight from L1, one chain an output
#pragma unroll
      for (int dx = 0; dx < 7; ++dx)
#pragma unroll
        for (int dy = 0; dy < 7; ++dy) {
          const int yy = y + dy - 3;
          if (yy < -HALO || yy >= H + HALO) continue;
          const T* src = xf + ((ptrdiff_t)yy * ld + x0 + dx - 3) * C + c;
          const float w = dw[(dy * 7 + dx) * C + c];
#pragma unroll
          for (int j = 0; j < SEG; ++j) {
            const int xx = x0 + j + dx - 3;
            const float in = inner || (xx >= -HALO && xx < W + HALO) ? to_f(src[(ptrdiff_t)j * C])
                                                                      : 0.f;
            sum[j] = fmaf(in, w, sum[j]);
          }
        }
    } else {
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const int yy = y + dy - 3;
        if (yy < -HALO || yy >= H + HALO) continue;
        const T* src = xf + ((ptrdiff_t)yy * ld + x0 - 3) * C + c;
        float in[SEG + 6], w[7];
        if (inner) {
#pragma unroll
          for (int j = 0; j < SEG + 6; ++j) in[j] = to_f(src[(ptrdiff_t)j * C]);
        } else {
#pragma unroll
          for (int j = 0; j < SEG + 6; ++j) {
            const int xx = x0 + j - 3;
            in[j] = xx >= -HALO && xx < W + HALO ? to_f(src[(ptrdiff_t)j * C]) : 0.f;
          }
        }
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) w[dx] = dw[(dy * 7 + dx) * C + c];
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          if constexpr (DW == kDwPerDy) {
            float prt = in[j] * w[0];
#pragma unroll
            for (int dx = 1; dx < 7; ++dx) prt = fmaf(in[j + dx], w[dx], prt);
            sum[j] += prt;
          } else if constexpr (DW == kDwTaps) {
#pragma unroll
            for (int dx = 0; dx < 7; ++dx) sum[j] = fmaf(in[j + dx], w[dx], sum[j]);
          } else {
#pragma unroll
            for (int dx = 0; dx < 7; ++dx) sum[j] = bf16_tap(sum[j], in[j + dx], w[dx]);
          }
        }
      }
    }
    if constexpr (DWONLY) {
      bf16* dst = a + (((size_t)f * H + y) * W + x0) * C + c;
#pragma unroll
      for (int j = 0; j < SEG; ++j)
        if (x0 + j < W) dst[(size_t)j * C] = __float2bfloat16(sum[j]);
    } else {
      const float bias = dwb[c];
#pragma unroll
      for (int j = 0; j < SEG; ++j)
        if (x0 + j < W) acc[(size_t)(x0 + j) * C + c] = sum[j] + bias;
    }
  }
  if constexpr (DWONLY) return;
  __syncthreads();

  // channel LN, one warp per pixel, a channel pair per lane and step (the
  // pads add exact zeros to the mean's sum; the variance skips them)
  const float invc = 1.f / (TRUEC ? Ct : C);
  const int C2 = C / 2;
  for (int q = warp; q < W; q += NT / 32) {
    const float2* row = (const float2*)(acc + (size_t)q * C);
    float s = 0.f;
    for (int g = lane; g < C2; g += 32) {
      const float2 v = row[g];
      s += v.x + v.y;
    }
    const float mu = warp_sum(s) * invc;
    float var = 0.f;
    for (int g = lane; g < C2; g += 32) {
      const float2 v = row[g];
      if constexpr (TRUEC) {
        const float d0 = 2 * g < Ct ? v.x - mu : 0.f, d1 = 2 * g + 1 < Ct ? v.y - mu : 0.f;
        var += d0 * d0 + d1 * d1;
      } else {
        const float d0 = v.x - mu, d1 = v.y - mu;
        var += d0 * d0 + d1 * d1;
      }
    }
    const float rstd = rsqrtf(warp_sum(var) * invc + 1e-6f);
    __nv_bfloat162* dst = (__nv_bfloat162*)(a + (((size_t)f * H + y) * W + q) * C);
    for (int g = lane; g < C2; g += 32) {
      const float2 v = row[g];
      dst[g] = __floats2bfloat162_rn(ln(v.x, mu, rstd, lnw[2 * g], lnb[2 * g]),
                                     ln(v.y, mu, rstd, lnw[2 * g + 1], lnb[2 * g + 1]));
    }
  }
}

}  // namespace cnx
