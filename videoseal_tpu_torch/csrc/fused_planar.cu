// K1: planar-u8 fused JND + prediction upsample + blend (+ detect downscale).
//
// Replaces videoseal_tpu/kernels/fused_planar.py::fused_jnd_blend_planar
// (Pallas body _blend_planar_kernel) and its XLA overlap-add epilogue.
//
// Bound on the H100: device-memory bytes. Per 1080p frame it reads the three
// u8 planes once (~6.6 MB, plus the JND halo rows, which hit L2) and writes
// the three u8 output planes (~6.6 MB); the low-res prediction rows it lifts
// (256 x 1920 f32) are re-read from L2. There is little arithmetic per byte,
// even with the full-res JND stencil.
//
// Design:
//  * One block per (frame, strip of RS output rows); the block sweeps the
//    strip in 256-column chunks, one thread per column, so each u8 plane row
//    is read and written by consecutive threads (coalesced bytes).
//  * Height lift: each output row has at most `lift_taps` nonzero taps of
//    _resize_matrix(s, h); the host passes per-row (start, weights) tables
//    instead of the TPU's 8-aligned row bands, and the kernel sums the taps.
//  * Full-res JND (lowres == 0): the block stages the luminance of its strip
//    plus a 2-row/2-column halo in shared memory, read straight from the
//    padded planar buffer, whose zero padding gives the JND its zero border.
//  * Detect downscale (ds > 0): the strip's final u8 rows stay in shared
//    memory and each is downscaled in width by a banded bf16 product
//    (vals and weights in bf16, f32 sums, result rounded to bf16) into
//    vd (F, 3, Hout, ds). A second kernel contracts the height with the
//    banded bf16 table mdh = _resize_matrix(h, ds) / 255, in a fixed order:
//    the overlap-add of the TPU's per-tile bands becomes a plain sum, with
//    no atomics, so the result is deterministic.
//  * Rounding is half to even (rintf), as jnp.round; si*v + delta is formed
//    with __fmul_rn/__fadd_rn so the compiler does not contract it into an
//    FMA that rounds differently from the plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int R0 = 28;     // image rows start here in the padded buffer
constexpr int C0 = 128;    // image cols start here
constexpr int RS = 4;      // output rows per block
constexpr int BT = 256;    // threads per block = columns per chunk
constexpr int LW = BT + 4; // staged luminance width (2-col halo each side)

__global__ void __launch_bounds__(BT)
blend_planar_kernel(const uint8_t* __restrict__ img, const float* __restrict__ tmp,
                    const int* __restrict__ lift_start, const float* __restrict__ lift_w,
                    int lift_taps, uint8_t* __restrict__ out, bf16* __restrict__ vd,
                    const int* __restrict__ dw_start, const bf16* __restrict__ dw_w,
                    int dw_taps, int Hp, int Wb, int Hout, int wq, int s, int ds,
                    int lowres, float si, float sw) {
  __shared__ float lum[(RS + 4) * LW];
  extern __shared__ uint8_t rowbuf[];  // (3, RS, wq) final u8 rows when ds > 0

  const int f = blockIdx.y;
  const int y0 = blockIdx.x * RS;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)Hp * Wb;
  const uint8_t* im = img + (size_t)f * 3 * plane;
  const float* tf = tmp + (size_t)f * s * wq;
  const float k255sw = 255.f * sw;

  for (int x0 = 0; x0 < wq; x0 += BT) {
    if (!lowres) {
      __syncthreads();  // the previous chunk is done with lum
      for (int idx = tid; idx < (RS + 4) * LW; idx += BT) {
        const int r = idx / LW;
        const int cx = idx - r * LW;
        const int gy = R0 + y0 - 2 + r;
        const int gx = C0 + x0 - 2 + cx;
        float v = 0.f;
        if (gx < Wb) {
          const size_t o = (size_t)gy * Wb + gx;
          v = 0.299f * (float)im[o] + 0.587f * (float)im[plane + o] +
              0.114f * (float)im[2 * plane + o];
        }
        lum[idx] = v;
      }
      __syncthreads();
    }
    const int x = x0 + tid;
    if (x < wq) {
      for (int r = 0; r < RS; ++r) {
        const int y = y0 + r;
        const int st = lift_start[y];
        const float* lw = lift_w + (size_t)y * lift_taps;
        float pred = 0.f;
        for (int t = 0; t < lift_taps; ++t) pred += lw[t] * tf[(size_t)(st + t) * wq + x];

        float delta;
        if (lowres) {
          delta = k255sw * pred;
        } else {
          // L[i * LW + j] is the luminance at (y - 2 + i, x - 2 + j)
          const float* L = lum + r * LW + tid;
          float c5 = 0.f;
          for (int j = 0; j < 5; ++j)
            c5 += (((L[j] + L[LW + j]) + L[2 * LW + j]) + L[3 * LW + j]) + L[4 * LW + j];
          float c3 = 0.f;
          for (int j = 1; j < 4; ++j) c3 += (L[LW + j] + L[2 * LW + j]) + L[3 * LW + j];
          float la = (c5 + c3 - 2.f * L[2 * LW + 2]) * (1.f / 32.f);
          const float lo = 17.f * (1.f - sqrtf(la * (1.f / 127.f) + 1e-5f));
          const float hi = (3.f / 128.f) * (la - 127.f) + 3.f;
          la = la <= 127.f ? lo : hi;
          const float gx = (L[LW + 3] + 2.f * L[2 * LW + 3] + L[3 * LW + 3]) -
                           (L[LW + 1] + 2.f * L[2 * LW + 1] + L[3 * LW + 1]);
          const float gy = (L[LW + 1] - L[3 * LW + 1]) + 2.f * (L[LW + 2] - L[3 * LW + 2]) +
                           (L[LW + 3] - L[3 * LW + 3]);
          const float cm2 = gx * gx + gy * gy;
          float cm = cm2 > 0.f
                         ? 16.f * expf(logf(fmaxf(cm2, 1e-20f)) * 1.2f) / (cm2 + 676.f)
                         : 0.f;
          cm *= 0.117f;
          const float heat = fmaxf(la + cm - 0.3f * fminf(la, cm), 0.f) * (1.f / 255.f);
          delta = (k255sw * heat) * pred;
        }

        const size_t src = (size_t)(R0 + y) * Wb + C0 + x;
        for (int c = 0; c < 3; ++c) {
          const float v = (float)im[c * plane + src];
          float o = __fadd_rn(__fmul_rn(si, v), delta);
          o = fminf(fmaxf(rintf(o), 0.f), 255.f);
          const uint8_t q = (uint8_t)o;
          out[(((size_t)f * 3 + c) * Hout + y) * wq + x] = q;
          if (ds > 0) rowbuf[(c * RS + r) * wq + x] = q;
        }
      }
    }
  }

  if (ds > 0) {
    __syncthreads();
    for (int idx = tid; idx < 3 * RS * ds; idx += BT) {
      const int cr = idx / ds;
      const int j = idx - cr * ds;
      const uint8_t* row = rowbuf + cr * wq + dw_start[j];
      const bf16* ww = dw_w + (size_t)j * dw_taps;
      float acc = 0.f;
      for (int t = 0; t < dw_taps; ++t) acc += (float)row[t] * __bfloat162float(ww[t]);
      const int c = cr / RS;
      const int r = cr - c * RS;
      vd[(((size_t)f * 3 + c) * Hout + y0 + r) * ds + j] = __float2bfloat16(acc);
    }
  }
}

// det[f, c, i, j] = sum_t mdh[i, t] * vd[f, c, start_i + t, j], f32 sums in tap order.
__global__ void detect_height_kernel(const bf16* __restrict__ vd,
                                     const int* __restrict__ dh_start,
                                     const bf16* __restrict__ dh_w, int dh_taps,
                                     float* __restrict__ det, int Hout, int ds) {
  const int i = blockIdx.x;
  const size_t fc = blockIdx.y;
  const int st = dh_start[i];
  const bf16* ww = dh_w + (size_t)i * dh_taps;
  const bf16* src = vd + (fc * Hout + st) * ds;
  for (int j = threadIdx.x; j < ds; j += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < dh_taps; ++t)
      acc += __bfloat162float(ww[t]) * __bfloat162float(src[(size_t)t * ds + j]);
    det[(fc * ds + i) * ds + j] = acc;
  }
}

}  // namespace

extern "C" int vs_blend_planar(const void* img, const void* tmp, const void* lift_start,
                               const void* lift_w, int lift_taps, void* out, void* vd,
                               const void* dw_start, const void* dw_w, int dw_taps, int F,
                               int Hp, int Wb, int Hout, int wq, int s, int ds, int lowres,
                               float si, float sw, void* stream) {
  const size_t smem = ds > 0 ? (size_t)3 * RS * wq : 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(blend_planar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(Hout / RS, F);
  blend_planar_kernel<<<grid, BT, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)tmp, (const int*)lift_start, (const float*)lift_w,
      lift_taps, (uint8_t*)out, (bf16*)vd, (const int*)dw_start, (const bf16*)dw_w, dw_taps,
      Hp, Wb, Hout, wq, s, ds, lowres, si, sw);
  return (int)cudaGetLastError();
}

extern "C" int vs_detect_height(const void* vd, const void* dh_start, const void* dh_w,
                                int dh_taps, void* det, int F, int Hout, int ds,
                                void* stream) {
  dim3 grid(ds, 3 * F);
  detect_height_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)vd, (const int*)dh_start, (const bf16*)dh_w, dh_taps, (float*)det, Hout,
      ds);
  return (int)cudaGetLastError();
}
