// The strip kernel of K6 (jnd_delta.cu) and of the K7 probe
// (jnd_probe.cu), and its launcher. K5 ran it until its row-streaming
// kernel (jnd_rows.cuh); K7's full_nosqrt at rs = 8 is that earlier K5, bit
// for bit. K4 runs its own design (jnd_up.cu).
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
//  * The epilogues use __fmul_rn/__fadd_rn where a contraction into an FMA
//    would round otherwise than the plain version.
//  * Template parameters beyond the kernels' epilogue (MODE) and input
//    types: the strip height R and the heat mode HM (jnd_heat.cuh), which
//    the K7 probe sweeps. K6 is the instance R = RS = 8, HM = kHeatNoSqrt.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "jnd_heat.cuh"

namespace {

constexpr int RS = 8;       // output rows per block of K5, K6
constexpr int BT = 256;     // threads per block = columns per chunk
constexpr int LW = BT + 4;  // staged luminance width (2-column halo each side)

enum Mode { kDelta = 1, kBlend = 2 };

__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// c0..c2: luminance weights on the input's scale (0.299 * 255 etc. for
// [0, 1] floats, 0.299 etc. for u8), so the luminance is in 0..255.
template <int MODE, typename TIn, typename TPred, int PC, int R = RS, int HM = kHeatNoSqrt>
__global__ void __launch_bounds__(BT)
jnd_kernel(const TIn* __restrict__ img, const TPred* __restrict__ pred, float* __restrict__ out,
           int H, int W, float c0, float c1, float c2, float si, float sw) {
  static_assert(HM != kHeatCopy || MODE == kDelta, "copy is a probe of K5 only");
  __shared__ float lum[(R + 4) * LW];

  const int f = blockIdx.y;
  const int y0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const size_t fpix = (size_t)f * H * W;
  const TIn* im = img + fpix * 3;

  for (int x0 = 0; x0 < W; x0 += BT) {
    __syncthreads();  // the previous chunk is done with lum
    for (int idx = tid; idx < (R + 4) * LW; idx += BT) {
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
    for (int r = 0; r < R; ++r) {
      const int y = y0 + r;
      if (y >= H) break;
      // L is the luminance at (y - 2, x - 2)
      const float* L = lum + r * LW + tid;
      const size_t o = fpix + (size_t)y * W + x;
      if constexpr (HM == kHeatCopy) {
        out[o] = __fadd_rn(__fmul_rn(sw, L[2 * LW]), to_f(pred[o]));
        continue;
      }
      const float swh = __fmul_rn(sw, jnd_heat<HM>(L, LW));
      if constexpr (MODE == kDelta) {
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

template <int MODE, typename TIn, typename TPred, int PC, int R = RS, int HM = kHeatNoSqrt>
int launch(const void* img, const void* pred, void* out, int F, int H, int W, float c0,
           float c1, float c2, float si, float sw, void* stream) {
  dim3 grid((H + R - 1) / R, F);
  jnd_kernel<MODE, TIn, TPred, PC, R, HM><<<grid, BT, 0, (cudaStream_t)stream>>>(
      (const TIn*)img, (const TPred*)pred, (float*)out, H, W, c0, c1, c2, si, sw);
  return (int)cudaGetLastError();
}

}  // namespace
