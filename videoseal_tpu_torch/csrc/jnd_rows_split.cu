// K5's split: its row-streaming kernel (jnd_rows.cuh) with the heat
// switched, to attribute its time. Replaces no TPU kernel; K7
// (jnd_probe.cu) is the same split of the strip design that K6 runs.
// mode: jnd_heat.cuh's HeatMode, copy 0 (the stages, the luminance and the
// window, then sw * lum(y, x - 2) + pred), sums 1 ((sw * (la + cm2)) *
// pred), production 3 (K5 itself); the rest as vs_jnd_delta.

#include "jnd_rows.cuh"

extern "C" int vs_jnd_delta_split(const void* img, int img_u8, const void* pred, void* out,
                                  int F, int H, int W, int rows, int band, int vec_frames,
                                  int vec_planes, float c0, float c1, float c2, float sw,
                                  int mode, void* stream) {
  const jnd_rows::Args a{img, (const float*)pred, (float*)out, H, W, rows, band,
                         band > 0 ? (W + band - 1) / band : 0, vec_frames, vec_planes,
                         c0, c1, c2, sw};
  switch (mode * 2 + (img_u8 != 0)) {
    case kHeatCopy * 2: return jnd_rows::launch<float, kHeatCopy>(a, F, stream);
    case kHeatCopy * 2 + 1: return jnd_rows::launch<uint8_t, kHeatCopy>(a, F, stream);
    case kHeatSums * 2: return jnd_rows::launch<float, kHeatSums>(a, F, stream);
    case kHeatSums * 2 + 1: return jnd_rows::launch<uint8_t, kHeatSums>(a, F, stream);
    case kHeatNoSqrt * 2: return jnd_rows::launch<float>(a, F, stream);
    case kHeatNoSqrt * 2 + 1: return jnd_rows::launch<uint8_t>(a, F, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
