// K1: planar-u8 fused JND + prediction upsample + blend (+ detect downscale).
//
// Replaces videoseal_tpu/kernels/fused_planar.py::fused_jnd_blend_planar
// (Pallas body _blend_planar_kernel), its XLA overlap-add epilogue, and the
// width resize of the prediction that the JAX package leaves to XLA.
//
// Bound on the H100: device-memory bytes. Per 1080p frame it reads the three
// u8 planes once (~6.6 MB) and writes the three u8 output planes (~6.6 MB);
// the low-res prediction (256 x 256 f32) is 0.26 MB. The lowres branch does
// ~40 instructions a pixel, the full-resolution JND ~150: there the CUDA
// cores, not the bytes, may set the time.
//
// Design (blend_up.cuh has the shared parts):
//  * One block per (frame, strip of RS output rows, band of up to 4096
//    columns); a thread owns 16 columns and walks the strip's rows, the
//    loads of the next row issued before the current one is computed. Every
//    u8 plane row is read and written as 16-byte words: C0 = 128, Wb and wq
//    are multiples of 128, so every row is 16-byte aligned. 1920 columns are
//    120 threads, none idle.
//  * The prediction's width resize is inside the kernel: the block stages
//    the low-res rows its strip lifts from, each thread keeps its columns'
//    width taps in registers (blend_up.cuh). No width-resized copy of the
//    prediction goes to device memory.
//  * Full-resolution JND (lowres == 0): the five-row rolling window of
//    luminance, read from the zero-padded planar buffer (the padding gives
//    the JND its zero border); heat from jnd_heat.cuh.
//  * Detect downscale (ds > 0, one band): each final u8 row also goes to
//    shared memory (as floats), and the block downscales it in width right
//    away, a thread per output column and all three planes, weights staged
//    once: a banded bf16 product (vals and weights in bf16, f32 sums,
//    rounded to bf16), into vd (F, 3, Hout, ds); the block then has whole
//    warps (128 threads for 1920 columns, 256 output columns in two rounds).
//    detect_height_kernel then contracts the height with the banded table
//    mdh = _resize_matrix(h, ds) / 255 in a fixed order, 8 columns a thread
//    from 16-byte loads: no atomics, so the result is deterministic.
//  * Rounding is half to even (rintf), as jnp.round; the blend and the JND
//    use __fmul_rn/__fadd_rn so the compiler does not contract them into
//    FMAs that round differently from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_up.cuh"

namespace {

using namespace blend_up;
typedef __nv_bfloat16 bf16;

constexpr int R0 = 28;     // image rows start here in the padded buffer
constexpr int C0 = 128;    // image cols start here

struct K1Args {
  const uint8_t* img;      // (F, 3, Hp, Wb) u8
  const float* pred_low;   // (F, s, s) f32
  const int* ls;           // lift band: start, weights (Hout, lt)
  const float* lw;
  const int* ws;           // width band: start, weights (wq, wt)
  const float* ww;
  uint8_t* out;            // (F, 3, Hout, wq) u8
  bf16* vd;                // (F, 3, Hout, ds) bf16
  const int* dws;          // detect width band (ds, dwt)
  const bf16* dww;
  int lt, wt, dwt, Hp, Wb, hout, h, wq, s, ds, rs, nl_max;
  float si, sw;
};

// The three u8 planes at 16 columns of one buffer row: p is plane 0's
// address, 16-byte aligned.
struct Planes {
  uint32_t wd[3][4];
  __device__ __forceinline__ void load(const uint8_t* p, size_t plane) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + c * plane);
      wd[c][0] = v.x, wd[c][1] = v.y, wd[c][2] = v.z, wd[c][3] = v.w;
    }
  }
  __device__ __forceinline__ float lum_at(int i) const {
    return lum(0.299f, 0.587f, 0.114f, byte_at(wd[0], i), byte_at(wd[1], i), byte_at(wd[2], i));
  }
};

// The planes' bytes at the window's four halo columns of one buffer row
// (band columns -2, -1, nt * G, nt * G + 1), zero outside the buffer columns
// the plain version reads (image columns -2 .. wq + 1). Thread 0 holds the
// left two, the band's last thread the right two.
struct Halo {
  uint8_t b[4][3];
  __device__ __forceinline__ void load(const uint8_t* row, size_t plane, int xb, int nt, int wq,
                                       int tid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool mine = k < 2 ? tid == 0 : tid == nt - 1;
      const int x = k < 2 ? xb - 2 + k : xb + nt * G + k - 2;
      const bool in = mine && x >= -2 && x < wq + 2;
#pragma unroll
      for (int c = 0; c < 3; ++c) b[k][c] = in ? row[c * plane + x] : 0;
    }
  }
  __device__ __forceinline__ float lum_at(int k) const {
    return lum(0.299f, 0.587f, 0.114f, (float)b[k][0], (float)b[k][1], (float)b[k][2]);
  }
};

template <bool LOWRES, bool DET, int WT, int HM = kHeatNoSqrt>
__global__ void __launch_bounds__(MAX_NT) blend_planar_kernel(const K1Args a) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ld = window_ld(nt);                   // window row: the band and its halo
  float* plw = reinterpret_cast<float*>(smem4);   // staged low-res rows
  float* ring = plw + ((a.nl_max * a.s + 3) & ~3);
  float* rowf = ring + (LOWRES ? 0 : 5 * ld);     // DET: the final row, 3 x wq, as floats
  float* dwf = rowf + 3 * a.wq;                   // DET: the width band's weights
  int* dwst = reinterpret_cast<int*>(dwf + a.ds * a.dwt);

  const int f = blockIdx.z;
  const int y0 = blockIdx.y * a.rs;
  const int y1 = min(y0 + a.rs, a.hout);
  const int xb = blockIdx.x * nt * G;             // the band's first column
  const int x0 = xb + tid * G;                    // the thread's first column
  const bool active = x0 < a.wq;                  // wq % 16 == 0: a whole group
  const size_t plane = (size_t)a.Hp * a.Wb;
  const uint8_t* im = a.img + (size_t)f * 3 * plane;
  const uint8_t* col = im + C0 + x0;              // row gy at col + (R0 + gy) * Wb
  const float k255sw = 255.f * a.sw;

  // the low-res rows of the strip's valid output rows (rows >= h lift nothing)
  const int yv1 = min(y1, a.h);
  const int rlo = y0 < yv1 ? a.ls[y0] : 0;
  if (y0 < yv1)
    stage_rows(plw, a.pred_low + ((size_t)f * a.s + rlo) * a.s,
               a.ls[yv1 - 1] + a.lt - rlo, a.s);
  if (DET) {
    for (int i = tid; i < a.ds * a.dwt; i += nt) dwf[i] = __bfloat162float(a.dww[i]);
    for (int i = tid; i < a.ds; i += nt) dwst[i] = a.dws[i];
  }
  WidthTaps<WT> taps;
  taps.load(a.ws, a.ww, a.wt, x0, a.wq);

  // window row gy from its planes and halo bytes, loaded a step ahead (every
  // window row is inside the buffer: rows R0 - 2 .. R0 + hout + 1)
  Planes nxt;
  Halo hnx;
  auto load_next = [&](int gy) {
    const uint8_t* rowp = im + (size_t)(R0 + gy) * a.Wb + C0;
    if (active) nxt.load(rowp + x0, plane);
    hnx.load(rowp, plane, xb, nt, a.wq, tid);
  };
  auto fill = [&](int gy) {
    float* r = ring_row(ring, gy, ld);
    const int c0 = PADL + tid * G;   // the thread's first window column
    if (active) {
#pragma unroll
      for (int i = 0; i < G; i += 4)
        *reinterpret_cast<float4*>(r + wcol(c0 + i)) =
            make_float4(nxt.lum_at(i), nxt.lum_at(i + 1), nxt.lum_at(i + 2), nxt.lum_at(i + 3));
    } else {
      // a thread past wq (a band of 128 threads for the detect pass): the
      // right halo columns wq, wq + 1 may be its own
      for (int i = 0; i < G; ++i) {
        const int x = x0 + i;
        const uint8_t* p = im + (size_t)(R0 + gy) * a.Wb + C0 + x;
        r[wcol(c0 + i)] = x < a.wq + 2 ? lum(0.299f, 0.587f, 0.114f, (float)p[0],
                                             (float)p[plane], (float)p[2 * plane])
                                       : 0.f;
      }
    }
    if (tid == 0) r[wcol(PADL - 2)] = hnx.lum_at(0), r[wcol(PADL - 1)] = hnx.lum_at(1);
    if (tid == nt - 1)
      r[wcol(PADL + nt * G)] = hnx.lum_at(2), r[wcol(PADL + nt * G + 1)] = hnx.lum_at(3);
  };
  if (!LOWRES) {
    for (int gy = y0 - 2; gy < y0 + 2; ++gy) {
      load_next(gy);
      fill(gy);
    }
    load_next(y0 + 2);
  } else if (active) {
    nxt.load(col + (size_t)(R0 + y0) * a.Wb, plane);
  }
  __syncthreads();

  for (int y = y0; y < y1; ++y) {
    Planes cur;   // the planes of row y
    if (!LOWRES) {
      if (active) cur.load(col + (size_t)(R0 + y) * a.Wb, plane);
      fill(y + 2);
      load_next(y + 3);
      __syncthreads();
    } else if (active) {
      cur = nxt;
      if (y + 1 < y1) nxt.load(col + (size_t)(R0 + y + 1) * a.Wb, plane);
    }
    if (active) {
      float p[G];
      if (y < a.h) {
        pred_up<WT>(p, taps, plw + (size_t)(a.ls[y] - rlo) * a.s, a.s,
                    a.lw + (size_t)y * a.lt, a.lt);
      } else {
#pragma unroll
        for (int i = 0; i < G; ++i) p[i] = 0.f;
      }
      float delta[G];
      if (LOWRES) {
#pragma unroll
        for (int i = 0; i < G; ++i) delta[i] = __fmul_rn(k255sw, p[i]);
      } else {
        float heat[G];
        heat_row<HM>(heat, ring, y, ld, tid * G);
#pragma unroll
        for (int i = 0; i < G; ++i) delta[i] = __fmul_rn(__fmul_rn(k255sw, heat[i]), p[i]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < G; ++i)
          put_byte(o, i, __fadd_rn(__fmul_rn(a.si, byte_at(cur.wd[c], i)), delta[i]));
        *reinterpret_cast<uint4*>(a.out + (((size_t)f * 3 + c) * a.hout + y) * a.wq + x0) =
            make_uint4(o[0], o[1], o[2], o[3]);
        if (DET) {
#pragma unroll
          for (int i = 0; i < G; i += 4)
            *reinterpret_cast<float4*>(rowf + c * a.wq + x0 + i) =
                make_float4(byte_at(o, i), byte_at(o, i + 1), byte_at(o, i + 2),
                            byte_at(o, i + 3));
        }
      }
    }
    if (DET && y < a.h) {
      // the row's width downscale: a thread per output column, all three
      // planes (rows >= h: the height pass reads no vd row there)
      __syncthreads();
      for (int j = tid; j < a.ds; j += nt) {
        const float* w = dwf + j * a.dwt;
        const float* r = rowf + dwst[j];
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
#pragma unroll 4
        for (int t = 0; t < a.dwt; ++t) {
          acc0 += r[t] * w[t];
          acc1 += r[a.wq + t] * w[t];
          acc2 += r[2 * a.wq + t] * w[t];
        }
        bf16* v = a.vd + ((size_t)f * 3 * a.hout + y) * a.ds + j;
        const size_t cs = (size_t)a.hout * a.ds;
        v[0] = __float2bfloat16(acc0);
        v[cs] = __float2bfloat16(acc1);
        v[2 * cs] = __float2bfloat16(acc2);
      }
    }
    if (!LOWRES || DET) __syncthreads();
  }
}

// det[f, c, i, j] = sum_t mdh[i, t] * vd[f, c, start_i + t, j], f32 sums in
// tap order; a thread takes 8 columns j (one 16-byte load of bf16 a tap).
__global__ void detect_height_kernel(const bf16* __restrict__ vd,
                                     const int* __restrict__ dh_start,
                                     const bf16* __restrict__ dh_w, int dh_taps,
                                     float* __restrict__ det, int Hout, int ds) {
  const int j = 8 * threadIdx.x;
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  const size_t fc = blockIdx.y;
  if (i >= ds || j >= ds) return;
  const bf16* ww = dh_w + (size_t)i * dh_taps;
  const bf16* src = vd + (fc * Hout + dh_start[i]) * ds + j;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < dh_taps; ++t) {
    const float wt = __bfloat162float(ww[t]);
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)t * ds);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(h2[k]);
      acc[2 * k] += wt * x.x;
      acc[2 * k + 1] += wt * x.y;
    }
  }
  float4* o = reinterpret_cast<float4*>(det + (fc * ds + i) * ds + j);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <bool LOWRES, bool DET, int WT, int HM = kHeatNoSqrt>
int launch(const K1Args& a, int F, void* stream) {
  const int groups = a.wq / G;
  // the detect pass spreads its ds output columns over whole warps
  const int nt = DET ? min(MAX_NT, (groups + 31) / 32 * 32) : min(MAX_NT, groups);
  const size_t smem = sizeof(float) * (((a.nl_max * a.s + 3) & ~3) +
                                       (LOWRES ? 0 : 5 * window_ld(nt)) +
                                       (DET ? 3 * a.wq + a.ds * (a.dwt + 1) : 0));
  auto kern = blend_planar_kernel<LOWRES, DET, WT, HM>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((groups + nt - 1) / nt, (a.hout + a.rs - 1) / a.rs, F);
  kern<<<grid, nt, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int WT>
int launch_wt(const K1Args& a, int F, int lowres, void* stream) {
  if (lowres)
    return a.ds ? launch<true, true, WT>(a, F, stream) : launch<true, false, WT>(a, F, stream);
  return a.ds ? launch<false, true, WT>(a, F, stream) : launch<false, false, WT>(a, F, stream);
}

}  // namespace

// wt == 2 takes the register-resident width taps, any other the general path.
extern "C" int vs_blend_planar(const void* img, const void* pred_low, const void* lift_start,
                               const void* lift_w, int lift_taps, const void* width_start,
                               const void* width_w, int width_taps, void* out, void* vd,
                               const void* dw_start, const void* dw_w, int dw_taps, int F,
                               int Hp, int Wb, int Hout, int h, int wq, int s, int ds,
                               int lowres, int rs, int nl_max, float si, float sw,
                               void* stream) {
  const K1Args a{(const uint8_t*)img, (const float*)pred_low, (const int*)lift_start,
                 (const float*)lift_w, (const int*)width_start, (const float*)width_w,
                 (uint8_t*)out, (bf16*)vd, (const int*)dw_start, (const bf16*)dw_w,
                 lift_taps, width_taps, dw_taps, Hp, Wb, Hout, h, wq, s, ds, rs, nl_max,
                 si, sw};
  return width_taps == 2 ? launch_wt<2>(a, F, lowres, stream) : launch_wt<0>(a, F, lowres, stream);
}

extern "C" int vs_detect_height(const void* vd, const void* dh_start, const void* dh_w,
                                int dh_taps, void* det, int F, int Hout, int ds,
                                void* stream) {
  const int bx = ds / 8;
  const int by = bx >= 256 ? 1 : 256 / bx;
  dim3 grid((ds + by - 1) / by, 3 * F);
  detect_height_kernel<<<grid, dim3(bx, by), 0, (cudaStream_t)stream>>>(
      (const bf16*)vd, (const int*)dh_start, (const bf16*)dh_w, dh_taps, (float*)det, Hout,
      ds);
  return (int)cudaGetLastError();
}

// K1's attribution variants, for timing only (chip_smoke.py phase 3): the
// full-resolution branch without the detect output and with 2 width taps,
// the heat replaced by the window's centre luminance (mode 0: the window and
// its barriers, no stencil) or by the raw stencil sums (mode 1: no
// transcendentals); mode 3 is the production heat.
extern "C" int vs_blend_planar_attr(const void* img, const void* pred_low,
                                    const void* lift_start, const void* lift_w, int lift_taps,
                                    const void* width_start, const void* width_w, int width_taps,
                                    void* out, int F, int Hp, int Wb, int Hout, int h, int wq,
                                    int s, int rs, int nl_max, float si, float sw, int mode,
                                    void* stream) {
  const K1Args a{(const uint8_t*)img, (const float*)pred_low, (const int*)lift_start,
                 (const float*)lift_w, (const int*)width_start, (const float*)width_w,
                 (uint8_t*)out, nullptr, nullptr, nullptr, lift_taps, width_taps, 0, Hp, Wb,
                 Hout, h, wq, s, 0, rs, nl_max, si, sw};
  if (width_taps != 2) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kHeatCopy: return launch<false, false, 2, kHeatCopy>(a, F, stream);
    case kHeatSums: return launch<false, false, 2, kHeatSums>(a, F, stream);
    case kHeatNoSqrt: return launch<false, false, 2, kHeatNoSqrt>(a, F, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
