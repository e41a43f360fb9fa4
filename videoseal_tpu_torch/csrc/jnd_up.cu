// K4: full-resolution JND delta of the upsampled prediction on NHWC frames,
// and the same with the RGB blend fused.
//
// Replaces videoseal_tpu/kernels/fused_blend.py::fused_jnd_delta_up (Pallas
// body _delta_up_kernel), the width resize of the prediction that the JAX
// package leaves to XLA, and, in blend mode, the fused XLA pass after it
// (videoseal_tpu/models/videoseal.py:222-233):
//   delta (F, H, W) f32 = sw * heat * upsample(pred_low);
//   blend, u8 frames:  out (F, H, W, 3) u8  = clip(round(si * v + 255 * delta), 0, 255);
//   blend, f32 frames: out (F, H, W, 3) f32 = clip(si * v + delta, 0, 1).
//
// Bound on the H100: device-memory bytes. At 1080p, F=128 (265.4 Mpx), each
// input byte read once and each output byte written once, at 3.35 TB/s:
//   delta, u8 frames:  3 B in + 4 B out a pixel   ~0.55 ms
//   blend, u8 frames:  3 B in + 3 B out a pixel   ~0.48 ms
//   blend, f32 frames: 12 B in + 12 B out a pixel ~1.9 ms
// plus 34 MB of pred_low. The heat is ~85 f32 operations a pixel, ~0.34 ms
// at the 67 TFLOP/s of the CUDA cores.
//
// Design (blend_up.cuh has the parts shared with K1):
//  * One block per (frame, strip of RS rows, band of up to 4096 columns); a
//    thread owns 16 pixels of a row and walks the strip's rows: 48 bytes of
//    u8 RGB, three 16-byte loads (and in blend mode three 16-byte stores);
//    f32 frames twelve.
//  * Any H and W: a group whose pixels are not all in the row, or whose
//    address is not 16-byte aligned (W = 1922: rows of 5766 bytes), takes a
//    masked scalar path in the same kernel.
//  * The width upsample from staged low-res rows and the rolling five-row
//    luminance window of blend_up.cuh; heat from jnd_heat.cuh, zeros outside
//    the image.
//  * __fmul_rn/__fadd_rn where a contraction into an FMA would round
//    otherwise than the plain version; u8 rounding half to even (rintf).

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_up.cuh"

namespace {

using namespace blend_up;

enum UpMode { kUpDelta = 0, kUpBlend = 1 };

struct K4Args {
  const void* img;         // (F, H, W, 3) u8 or f32
  const float* pred_low;   // (F, s, s) f32
  const int* ls;           // lift band (H, lt)
  const float* lw;
  const int* ws;           // width band (W, wt)
  const float* ww;
  void* out;               // delta (F, H, W) f32, or the blended frames
  int lt, wt, H, W, s, rs, nl_max;
  float c0, c1, c2, si, sw;
};

// The 3 * n values of n <= 16 NHWC pixels at p; vec: n == 16 and p 16-byte
// aligned, so three (u8) or twelve (f32) 16-byte loads. The masked loops are
// unrolled so that the register arrays keep constant indices.
__device__ __forceinline__ void load_px(float (&v)[3 * G], const uint8_t* p, bool vec, int n) {
  if (vec) {
    uint32_t wd[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      wd[4 * k] = q.x, wd[4 * k + 1] = q.y, wd[4 * k + 2] = q.z, wd[4 * k + 3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < 3 * G; ++k) v[k] = byte_at(wd, k);
    return;
  }
#pragma unroll
  for (int k = 0; k < 3 * G; ++k) v[k] = k < 3 * n ? (float)p[k] : 0.f;
}

__device__ __forceinline__ void load_px(float (&v)[3 * G], const float* p, bool vec, int n) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < 3 * G / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 3 * G; ++k) v[k] = k < 3 * n ? p[k] : 0.f;
}

// The blended values of n pixels into the frame's own type at o.
__device__ __forceinline__ void store_blend(uint8_t* o, const float (&v)[3 * G],
                                            const float (&delta)[G], float si, bool vec, int n) {
  if (vec) {
    uint32_t wd[12] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 3 * G; ++k)
      put_byte(wd, k, __fadd_rn(__fmul_rn(si, v[k]), __fmul_rn(255.f, delta[k / 3])));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      reinterpret_cast<uint4*>(o)[k] =
          make_uint4(wd[4 * k], wd[4 * k + 1], wd[4 * k + 2], wd[4 * k + 3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 3 * G; ++k) {
    if (k >= 3 * n) break;
    const float x = __fadd_rn(__fmul_rn(si, v[k]), __fmul_rn(255.f, delta[k / 3]));
    o[k] = (uint8_t)fminf(fmaxf(rintf(x), 0.f), 255.f);
  }
}

__device__ __forceinline__ void store_blend(float* o, const float (&v)[3 * G],
                                            const float (&delta)[G], float si, bool vec, int n) {
  float r[3 * G];
#pragma unroll
  for (int k = 0; k < 3 * G; ++k)
    r[k] = fminf(fmaxf(__fadd_rn(__fmul_rn(si, v[k]), delta[k / 3]), 0.f), 1.f);
  if (vec) {
#pragma unroll
    for (int k = 0; k < 3 * G / 4; ++k)
      reinterpret_cast<float4*>(o)[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2],
                                                    r[4 * k + 3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 3 * G; ++k)
    if (k < 3 * n) o[k] = r[k];
}

// 16 whole NHWC pixels of one row held as loaded, 16-byte words.
template <typename T>
struct Raw;
template <>
struct Raw<uint8_t> {
  uint4 q[3];
  __device__ __forceinline__ void load(const uint8_t* p) {
#pragma unroll
    for (int k = 0; k < 3; ++k) q[k] = reinterpret_cast<const uint4*>(p)[k];
  }
  __device__ __forceinline__ float at(int k) const {
    const uint4& v = q[k / 16];
    const int b = k % 16;
    const uint32_t w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
    return (float)((w >> (8 * (b & 3))) & 0xffu);
  }
};
template <>
struct Raw<float> {
  float4 q[12];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int k = 0; k < 12; ++k) q[k] = reinterpret_cast<const float4*>(p)[k];
  }
  __device__ __forceinline__ float at(int k) const {
    const float4& v = q[k / 4];
    return k % 4 == 0 ? v.x : k % 4 == 1 ? v.y : k % 4 == 2 ? v.z : v.w;
  }
};

template <typename T, int MODE, int WT>
__global__ void __launch_bounds__(MAX_NT) jnd_up_kernel(const K4Args a) {
  extern __shared__ float4 smem4[];
  float* plw = reinterpret_cast<float*>(smem4);    // staged low-res rows
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ld = window_ld(nt);                      // window row: the band and its halo
  float* ring = plw + ((a.nl_max * a.s + 3) & ~3);

  const int f = blockIdx.z;
  const int y0 = blockIdx.y * a.rs;
  const int y1 = min(y0 + a.rs, a.H);
  const int xb = blockIdx.x * nt * G;
  const int x0 = xb + tid * G;
  const int n = max(0, min(G, a.W - x0));            // the thread's pixels in the row
  const T* im = reinterpret_cast<const T*>(a.img) + (size_t)f * a.H * a.W * 3;
  auto row = [&](int gy) { return im + ((size_t)gy * a.W + x0) * 3; };
  // 16 whole pixels at a 16-byte aligned address: the 16-byte loads
  auto vec = [&](int gy) { return n == G && aligned16(row(gy)); };

  const int rlo = a.ls[y0];
  stage_rows(plw, a.pred_low + ((size_t)f * a.s + rlo) * a.s, a.ls[y1 - 1] + a.lt - rlo, a.s);
  WidthTaps<WT> taps;
  taps.load(a.ws, a.ww, a.wt, x0, a.W);

  auto pixel_lum = [&](int gy, int x) {
    if (gy < 0 || gy >= a.H || x < 0 || x >= a.W) return 0.f;
    const T* p = im + ((size_t)gy * a.W + x) * 3;
    return lum(a.c0, a.c1, a.c2, (float)p[0], (float)p[1], (float)p[2]);
  };
  // window row gy: the thread's pixels (from nxt where the row takes the
  // 16-byte loads), the halo
  Raw<T> nxt;   // the next window row, loaded a step ahead
  auto load_next = [&](int gy) {
    if (gy >= 0 && gy < a.H && vec(gy)) nxt.load(row(gy));
  };
  auto fill = [&](int gy) {
    float* r = ring_row(ring, gy, ld);
    const int c0 = PADL + tid * G;   // the thread's first window column
    if (gy >= 0 && gy < a.H && vec(gy)) {
#pragma unroll
      for (int i = 0; i < G; i += 4) {
        float l[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          l[u] = lum(a.c0, a.c1, a.c2, nxt.at(3 * (i + u)), nxt.at(3 * (i + u) + 1),
                     nxt.at(3 * (i + u) + 2));
        *reinterpret_cast<float4*>(r + wcol(c0 + i)) = make_float4(l[0], l[1], l[2], l[3]);
      }
    } else {
      for (int i = 0; i < G; ++i) r[wcol(c0 + i)] = pixel_lum(gy, x0 + i);
    }
    if (tid == 0)
      r[wcol(PADL - 2)] = pixel_lum(gy, xb - 2), r[wcol(PADL - 1)] = pixel_lum(gy, xb - 1);
    if (tid == nt - 1)
      r[wcol(PADL + nt * G)] = pixel_lum(gy, xb + nt * G),
      r[wcol(PADL + nt * G + 1)] = pixel_lum(gy, xb + nt * G + 1);
  };
  for (int gy = y0 - 2; gy < y0 + 2; ++gy) {
    load_next(gy);
    fill(gy);
  }
  load_next(y0 + 2);
  __syncthreads();

  for (int y = y0; y < y1; ++y) {
    fill(y + 2);
    load_next(y + 3);
    __syncthreads();
    if (n > 0) {
      float p[G], heat[G], delta[G];
      pred_up<WT>(p, taps, plw + (size_t)(a.ls[y] - rlo) * a.s, a.s, a.lw + (size_t)y * a.lt,
                  a.lt);
      heat_row(heat, ring, y, ld, tid * G);
#pragma unroll
      for (int i = 0; i < G; ++i) delta[i] = __fmul_rn(__fmul_rn(a.sw, heat[i]), p[i]);
      const size_t px = ((size_t)f * a.H + y) * a.W + x0;
      if constexpr (MODE == kUpDelta) {
        float* o = reinterpret_cast<float*>(a.out) + px;
        if (n == G && aligned16(o)) {
#pragma unroll
          for (int k = 0; k < G / 4; ++k)
            reinterpret_cast<float4*>(o)[k] =
                make_float4(delta[4 * k], delta[4 * k + 1], delta[4 * k + 2], delta[4 * k + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < G; ++i)
            if (i < n) o[i] = delta[i];
        }
      } else {
        const T* src = reinterpret_cast<const T*>(a.img) + px * 3;
        T* o = reinterpret_cast<T*>(a.out) + px * 3;
        const bool v16 = n == G && aligned16(src) && aligned16(o);
        float v[3 * G];
        load_px(v, src, v16, n);
        store_blend(o, v, delta, a.si, v16, n);
      }
    }
    __syncthreads();
  }
}

template <typename T, int MODE, int WT>
int launch(const K4Args& a, int F, void* stream) {
  const int groups = (a.W + G - 1) / G;
  const int nt = groups < MAX_NT ? groups : MAX_NT;
  const size_t smem = sizeof(float) * (((a.nl_max * a.s + 3) & ~3) + 5 * window_ld(nt));
  auto kern = jnd_up_kernel<T, MODE, WT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((groups + nt - 1) / nt, (a.H + a.rs - 1) / a.rs, F);
  kern<<<grid, nt, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_wt(const K4Args& a, int F, void* stream) {
  return a.wt == 2 ? launch<T, MODE, 2>(a, F, stream) : launch<T, MODE, 0>(a, F, stream);
}

}  // namespace

// K4. img (F,H,W,3) u8 (img_u8 != 0) or f32; pred_low (F,s,s) f32; lift and
// width bands; mode 0: out = delta (F,H,W) f32, mode 1: out = the blended
// frames (F,H,W,3) in img's type. wt == 2 takes the register-resident width
// taps, any other the general path. c0..c2: the luminance weights on the
// frames' scale.
extern "C" int vs_jnd_up(const void* img, int img_u8, const void* pred_low,
                         const void* lift_start, const void* lift_w, int lift_taps,
                         const void* width_start, const void* width_w, int width_taps, void* out,
                         int mode, int F, int H, int W, int s, int rs, int nl_max, float c0,
                         float c1, float c2, float si, float sw, void* stream) {
  const K4Args a{img, (const float*)pred_low, (const int*)lift_start, (const float*)lift_w,
                 (const int*)width_start, (const float*)width_w, out, lift_taps, width_taps, H,
                 W, s, rs, nl_max, c0, c1, c2, si, sw};
  if (img_u8)
    return mode ? launch_wt<uint8_t, kUpBlend>(a, F, stream)
                : launch_wt<uint8_t, kUpDelta>(a, F, stream);
  return mode ? launch_wt<float, kUpBlend>(a, F, stream)
              : launch_wt<float, kUpDelta>(a, F, stream);
}
