// The JND heat of one pixel (jnd_1_1: luminance masking and contrast
// masking combined with an overlap term), the math of
// videoseal_tpu/kernels/fused_blend.py::_jnd_heatmap_tile, used by the
// strip kernel of jnd_delta.cuh (K5, K6, K7) and by K1 and K4 (blend_up.cuh).
//
// jnd_heat(L, ld): L points at the luminance (0..255) at (y - 2, x - 2) of
// a row-major tile with row stride ld; the 5x5 neighbourhood
// L[i * ld + j], 0 <= i, j < 5, must be staged, with zeros outside the image.
// jnd_heat_rows(r0, ..., r4) is the same arithmetic with the five rows given
// one by one (r[i][j] = L[i * ld + j]): K1 and K4 (blend_up.cuh) keep their
// rows in a rolling window whose rows are not evenly spaced in shared memory.
//
// The sums run in the order of the plain version
// (kernels/fused_blend.py::_heat_plain), and the products that feed a sum
// are __fmul_rn so that the compiler does not contract them into FMAs that
// round otherwise.
//
// HM selects what is returned, for the K7 probe (kernels/jnd_probe.py)
// after videoseal_tpu/kernels/jnd_probe.py's variants: kHeatNoSqrt is the
// production heat (cm2^1.2); kHeatSqrt the same heat through sqrt(cm2)^2.4;
// kHeatSums the raw stencil sums la + cm2 with no transcendentals.

#pragma once

enum HeatMode { kHeatCopy = 0, kHeatSums = 1, kHeatSqrt = 2, kHeatNoSqrt = 3 };

// The heat from the stencil's sums: c5 and c3 the 5x5 and 3x3 box sums,
// centre the pixel's luminance, t1 and t3 the vertical Sobel sums of the
// columns left and right of it, gy the horizontal one of the row above minus
// the row below, each as jnd_heat_rows forms it.
template <int HM = kHeatNoSqrt>
__device__ __forceinline__ float jnd_heat_sums(float c5, float c3, float centre, float t1,
                                               float t3, float gy) {
  float la = __fmul_rn(__fsub_rn(__fadd_rn(c5, c3), 2.f * centre), 1.f / 32.f);
  const float gx = t3 - t1;
  const float cm2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  if constexpr (HM == kHeatSums) return __fadd_rn(la, cm2);

  const float lo =
      17.f * (1.f - sqrtf(__fadd_rn(__fmul_rn(la, 1.f / 127.f), 1e-5f)));
  const float hi = __fadd_rn(__fmul_rn(3.f / 128.f, la - 127.f), 3.f);
  la = la <= 127.f ? lo : hi;
  float cm = 0.f;
  if constexpr (HM == kHeatSqrt) {
    if (cm2 > 0.f)
      cm = __fmul_rn(16.f, expf(logf(fmaxf(sqrtf(cm2), 1e-20f)) * 2.4f)) / (cm2 + 676.f);
  } else {
    if (cm2 > 0.f)
      cm = __fmul_rn(16.f, expf(logf(fmaxf(cm2, 1e-20f)) * 1.2f)) / (cm2 + 676.f);
  }
  cm = __fmul_rn(0.117f, cm);

  const float heat = __fsub_rn(__fadd_rn(la, cm), __fmul_rn(0.3f, fminf(la, cm)));
  return __fmul_rn(fmaxf(heat, 0.f), 1.f / 255.f);
}

template <int HM = kHeatNoSqrt>
__device__ __forceinline__ float jnd_heat_rows(const float* __restrict__ r0,
                                               const float* __restrict__ r1,
                                               const float* __restrict__ r2,
                                               const float* __restrict__ r3,
                                               const float* __restrict__ r4) {
  // luminance masking: the 5x5 kernel is box5 + box3 - 2 * centre, over 32
  float c5 = 0.f;
  for (int j = 0; j < 5; ++j)
    c5 += (((r0[j] + r1[j]) + r2[j]) + r3[j]) + r4[j];
  float c3 = 0.f;
  for (int j = 1; j < 4; ++j) c3 += (r1[j] + r2[j]) + r3[j];
  // contrast masking: separable Sobel, cm = 0.117 * 16 * cm2^1.2 / (cm2 + 676)
  const float t3 = __fadd_rn(r1[3] + 2.f * r2[3], r3[3]);
  const float t1 = __fadd_rn(r1[1] + 2.f * r2[1], r3[1]);
  const float gy = __fadd_rn((r1[1] - r3[1]) + 2.f * (r1[2] - r3[2]), r1[3] - r3[3]);
  return jnd_heat_sums<HM>(c5, c3, r2[2], t1, t3, gy);
}

template <int HM = kHeatNoSqrt>
__device__ __forceinline__ float jnd_heat(const float* __restrict__ L, int ld) {
  return jnd_heat_rows<HM>(L, L + ld, L + 2 * ld, L + 3 * ld, L + 4 * ld);
}
