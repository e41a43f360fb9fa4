// K5, K6: full-resolution JND on NHWC frames. (K4 runs its own design:
// jnd_up.cu.)
//
// Replaces, in videoseal_tpu/kernels/fused_blend.py:
//   K5 fused_jnd_delta (_delta_kernel): delta = sw * heat * pred (F,H,W);
//   K6 fused_jnd_blend (_kernel): out (F,H,W,3) f32 =
//        clip(si * img + sw * heat * pred, 0, 1), pred (F,H,W,1|3) f32 or bf16.
//
// K5 runs the row-streaming kernel of jnd_rows.cuh (its design and bound
// are there). K6 runs the strip kernel of jnd_delta.cuh, which the K7 probe
// (jnd_probe.cu) also instantiates: K7's full_nosqrt at rs = 8 is K5's
// earlier strip design, bit for bit the same delta.
//
// K6's bound on the H100: device-memory bytes. At 1080p, F=128 (265.4 Mpx),
// with each input byte read once and each output byte written once, at
// 3.35 TB/s:
//   f32, 1-channel prediction: 12 + 4 + 12 B per pixel            ~2.2 ms
//   f32, 3-channel prediction: 12 + 12 + 12 B per pixel           ~2.9 ms
// The heat is ~80 f32 operations per pixel, ~0.3 ms at the 67 TFLOP/s of
// the CUDA cores: under the bytes in every case.

#include "jnd_delta.cuh"
#include "jnd_rows.cuh"

// K5. img (F,H,W,3) u8 (img_u8 != 0) or f32; pred (F,H,W) f32; out (F,H,W)
// f32. The geometry comes from the wrapper (fused_blend.py::k5_geometry):
// `rows` output rows and `band` columns a block (band a multiple of 16, at
// most 2048), and the 16-byte paths for the frames and for the prediction
// and output; the launcher refuses a geometry that does not hold
// (cudaErrorInvalidValue).
extern "C" int vs_jnd_delta(const void* img, int img_u8, const void* pred, void* out, int F,
                            int H, int W, int rows, int band, int vec_frames, int vec_planes,
                            float c0, float c1, float c2, float sw, void* stream) {
  const jnd_rows::Args a{img, (const float*)pred, (float*)out, H, W, rows, band,
                         band > 0 ? (W + band - 1) / band : 0, vec_frames, vec_planes,
                         c0, c1, c2, sw};
  if (img_u8) return jnd_rows::launch<uint8_t>(a, F, stream);
  return jnd_rows::launch<float>(a, F, stream);
}

// K5's instance for img_u8 at `band` columns: jnd_rows::info.
extern "C" int vs_jnd_delta_info(int img_u8, int band, int* info) {
  if (img_u8) return jnd_rows::info<uint8_t>(band, info);
  return jnd_rows::info<float>(band, info);
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
