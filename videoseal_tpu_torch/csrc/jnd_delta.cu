// K5, K6: full-resolution JND on NHWC frames, two entry points of one
// kernel template. (K4 runs its own design: jnd_up.cu.)
//
// Replaces, in videoseal_tpu/kernels/fused_blend.py:
//   K5 fused_jnd_delta (_delta_kernel): delta = sw * heat * pred (F,H,W);
//   K6 fused_jnd_blend (_kernel): out (F,H,W,3) f32 =
//        clip(si * img + sw * heat * pred, 0, 1), pred (F,H,W,1|3) f32 or bf16.
//
// Bound on the H100: device-memory bytes. At 1080p, F=128 (265.4 Mpx), with
// each input byte read once and each output byte written once, at 3.35 TB/s:
//   K5, f32:        12 + 4 + 4 B per pixel                         ~1.6 ms
//   K6, f32, 1-channel prediction: 12 + 4 + 12 B per pixel         ~2.2 ms
//   K6, f32, 3-channel prediction: 12 + 12 + 12 B per pixel        ~2.9 ms
// The heat is ~80 f32 operations per pixel, ~0.3 ms at the 67 TFLOP/s of
// the CUDA cores: under the bytes in every case.
//
// The strip kernel and its design are in jnd_delta.cuh.

#include "jnd_delta.cuh"

// K5. img (F,H,W,3) u8 or f32; pred (F,H,W) f32; out (F,H,W) f32.
extern "C" int vs_jnd_delta(const void* img, int img_u8, const void* pred, void* out, int F,
                            int H, int W, float c0, float c1, float c2, float sw,
                            void* stream) {
  if (img_u8)
    return launch<kDelta, uint8_t, float, 1>(img, pred, out, F, H, W, c0, c1, c2, 0.f, sw,
                                             stream);
  return launch<kDelta, float, float, 1>(img, pred, out, F, H, W, c0, c1, c2, 0.f, sw,
                                         stream);
}

// K6. img (F,H,W,3) f32; pred (F,H,W,pred_c) f32 or bf16 (pred_bf16 != 0);
// out (F,H,W,3) f32.
extern "C" int vs_jnd_blend(const void* img, const void* pred, int pred_bf16, int pred_c,
                            void* out, int F, int H, int W, float c0, float c1, float c2,
                            float si, float sw, void* stream) {
  typedef __nv_bfloat16 bf16;
  if (pred_bf16) {
    if (pred_c == 3)
      return launch<kBlend, float, bf16, 3>(img, pred, out, F, H, W, c0, c1, c2, si, sw, stream);
    return launch<kBlend, float, bf16, 1>(img, pred, out, F, H, W, c0, c1, c2, si, sw, stream);
  }
  if (pred_c == 3)
    return launch<kBlend, float, float, 3>(img, pred, out, F, H, W, c0, c1, c2, si, sw, stream);
  return launch<kBlend, float, float, 1>(img, pred, out, F, H, W, c0, c1, c2, si, sw, stream);
}
