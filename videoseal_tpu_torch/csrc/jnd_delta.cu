// K4, K5, K6: full-resolution JND on NHWC frames, three entry points of one
// kernel template.
//
// Replaces, in videoseal_tpu/kernels/fused_blend.py:
//   K4 fused_jnd_delta_up (Pallas body _delta_up_kernel):
//        delta (F,H,W) f32 = sw * heat * (height lift of tmp), where
//        tmp = pred_low @ mw^T is the width-resized prediction (F, s, W),
//        computed by a torch matmul outside the kernel as the JAX package
//        leaves it to XLA;
//   K5 fused_jnd_delta (_delta_kernel): delta = sw * heat * pred (F,H,W);
//   K6 fused_jnd_blend (_kernel): out (F,H,W,3) f32 =
//        clip(si * img + sw * heat * pred, 0, 1), pred (F,H,W,1|3) f32 or bf16.
//
// Bound on the H100: device-memory bytes. At 1080p, F=128 (265.4 Mpx), with
// each input byte read once and each output byte written once, at 3.35 TB/s:
//   K4, u8 frames:  3 B in + 4 B out per pixel, + 0.25 GB of tmp   ~0.63 ms
//   K4, f32 frames: 12 + 4 B per pixel, + 0.25 GB of tmp           ~1.34 ms
//   K5, f32:        12 + 4 + 4 B per pixel                         ~1.6 ms
//   K6, f32, 1-channel prediction: 12 + 4 + 12 B per pixel         ~2.2 ms
//   K6, f32, 3-channel prediction: 12 + 12 + 12 B per pixel        ~2.9 ms
// The heat is ~80 f32 operations per pixel, ~0.3 ms at the 67 TFLOP/s of
// the CUDA cores: under the bytes in every case.
//
// Design (simple and right first):
//  * One block per (frame, strip of RS rows); the block sweeps the strip in
//    BT-column chunks, one thread per column. For each chunk it stages the
//    luminance of the strip plus a 2-row/2-column halo in shared memory,
//    computed there from the NHWC frame, so the padded f32 luminance plane
//    that the JAX package builds in XLA never goes to device memory. Zeros
//    outside the image give the JND its zero border; the ragged edges of any
//    H and W are masked here, with no padding of the frame.
//  * The heat is jnd_heat() of jnd_heat.cuh.
//  * K4's height lift: each output row has at most lift_taps nonzero taps of
//    _resize_matrix(s, H); the host passes per-row (start, weights) tables
//    (as K1 does) instead of the TPU's 8-aligned row bands.
//  * The epilogues use __fmul_rn/__fadd_rn where a contraction into an FMA
//    would round otherwise than the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jnd_heat.cuh"

namespace {

constexpr int RS = 8;       // output rows per block
constexpr int BT = 256;     // threads per block = columns per chunk
constexpr int LW = BT + 4;  // staged luminance width (2-column halo each side)

enum Mode { kDeltaUp = 0, kDelta = 1, kBlend = 2 };

__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// c0..c2: luminance weights on the input's scale (0.299 * 255 etc. for
// [0, 1] floats, 0.299 etc. for u8), so the luminance is in 0..255.
template <int MODE, typename TIn, typename TPred, int PC>
__global__ void __launch_bounds__(BT)
jnd_kernel(const TIn* __restrict__ img, const float* __restrict__ tmp,
           const int* __restrict__ lift_start, const float* __restrict__ lift_w,
           int lift_taps, const TPred* __restrict__ pred, float* __restrict__ out, int H,
           int W, int s, float c0, float c1, float c2, float si, float sw) {
  __shared__ float lum[(RS + 4) * LW];

  const int f = blockIdx.y;
  const int y0 = blockIdx.x * RS;
  const int tid = threadIdx.x;
  const size_t fpix = (size_t)f * H * W;
  const TIn* im = img + fpix * 3;

  for (int x0 = 0; x0 < W; x0 += BT) {
    __syncthreads();  // the previous chunk is done with lum
    for (int idx = tid; idx < (RS + 4) * LW; idx += BT) {
      const int r = idx / LW;
      const int gy = y0 - 2 + r;
      const int gx = x0 - 2 + (idx - r * LW);
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const TIn* p = im + ((size_t)gy * W + gx) * 3;
        v = __fadd_rn(__fadd_rn(__fmul_rn(c0, to_f(p[0])), __fmul_rn(c1, to_f(p[1]))),
                      __fmul_rn(c2, to_f(p[2])));
      }
      lum[idx] = v;
    }
    __syncthreads();

    const int x = x0 + tid;
    if (x >= W) continue;
    for (int r = 0; r < RS; ++r) {
      const int y = y0 + r;
      if (y >= H) break;
      // lum + r * LW + tid is the luminance at (y - 2, x - 2)
      const float swh = __fmul_rn(sw, jnd_heat(lum + r * LW + tid, LW));
      const size_t o = fpix + (size_t)y * W + x;
      if constexpr (MODE == kDeltaUp) {
        const int st = lift_start[y];
        const float* lw = lift_w + (size_t)y * lift_taps;
        const float* tp = tmp + ((size_t)f * s + st) * W + x;
        float p = 0.f;
        for (int t = 0; t < lift_taps; ++t)
          p = __fadd_rn(p, __fmul_rn(lw[t], tp[(size_t)t * W]));
        out[o] = __fmul_rn(swh, p);
      } else if constexpr (MODE == kDelta) {
        out[o] = __fmul_rn(swh, to_f(pred[o]));
      } else {
        for (int c = 0; c < 3; ++c) {
          const float pv = to_f(pred[o * PC + (PC == 3 ? c : 0)]);
          const float v = __fadd_rn(__fmul_rn(si, to_f(im[(o - fpix) * 3 + c])),
                                    __fmul_rn(swh, pv));
          out[o * 3 + c] = fminf(fmaxf(v, 0.f), 1.f);
        }
      }
    }
  }
}

template <int MODE, typename TIn, typename TPred, int PC>
int launch(const void* img, const void* tmp, const void* lift_start, const void* lift_w,
           int lift_taps, const void* pred, void* out, int F, int H, int W, int s, float c0,
           float c1, float c2, float si, float sw, void* stream) {
  dim3 grid((H + RS - 1) / RS, F);
  jnd_kernel<MODE, TIn, TPred, PC><<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const TIn*)img, (const float*)tmp, (const int*)lift_start, (const float*)lift_w,
      lift_taps, (const TPred*)pred, (float*)out, H, W, s, c0, c1, c2, si, sw);
  return (int)cudaGetLastError();
}

}  // namespace

// K4. img (F,H,W,3) u8 (img_u8 != 0) or f32; tmp (F,s,W) f32; out (F,H,W) f32.
extern "C" int vs_jnd_delta_up(const void* img, int img_u8, const void* tmp,
                               const void* lift_start, const void* lift_w, int lift_taps,
                               void* out, int F, int H, int W, int s, float c0, float c1,
                               float c2, float sw, void* stream) {
  if (img_u8)
    return launch<kDeltaUp, uint8_t, float, 1>(img, tmp, lift_start, lift_w, lift_taps,
                                               nullptr, out, F, H, W, s, c0, c1, c2, 0.f,
                                               sw, stream);
  return launch<kDeltaUp, float, float, 1>(img, tmp, lift_start, lift_w, lift_taps, nullptr,
                                           out, F, H, W, s, c0, c1, c2, 0.f, sw, stream);
}

// K5. img (F,H,W,3) u8 or f32; pred (F,H,W) f32; out (F,H,W) f32.
extern "C" int vs_jnd_delta(const void* img, int img_u8, const void* pred, void* out, int F,
                            int H, int W, float c0, float c1, float c2, float sw,
                            void* stream) {
  if (img_u8)
    return launch<kDelta, uint8_t, float, 1>(img, nullptr, nullptr, nullptr, 0, pred, out, F,
                                             H, W, 0, c0, c1, c2, 0.f, sw, stream);
  return launch<kDelta, float, float, 1>(img, nullptr, nullptr, nullptr, 0, pred, out, F, H,
                                         W, 0, c0, c1, c2, 0.f, sw, stream);
}

// K6. img (F,H,W,3) f32; pred (F,H,W,pred_c) f32 or bf16 (pred_bf16 != 0);
// out (F,H,W,3) f32.
extern "C" int vs_jnd_blend(const void* img, const void* pred, int pred_bf16, int pred_c,
                            void* out, int F, int H, int W, float c0, float c1, float c2,
                            float si, float sw, void* stream) {
  typedef __nv_bfloat16 bf16;
  if (pred_bf16) {
    if (pred_c == 3)
      return launch<kBlend, float, bf16, 3>(img, nullptr, nullptr, nullptr, 0, pred, out, F,
                                            H, W, 0, c0, c1, c2, si, sw, stream);
    return launch<kBlend, float, bf16, 1>(img, nullptr, nullptr, nullptr, 0, pred, out, F, H,
                                          W, 0, c0, c1, c2, si, sw, stream);
  }
  if (pred_c == 3)
    return launch<kBlend, float, float, 3>(img, nullptr, nullptr, nullptr, 0, pred, out, F, H,
                                           W, 0, c0, c1, c2, si, sw, stream);
  return launch<kBlend, float, float, 1>(img, nullptr, nullptr, nullptr, 0, pred, out, F, H, W,
                                         0, c0, c1, c2, si, sw, stream);
}
