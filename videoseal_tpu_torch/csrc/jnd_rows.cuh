// K5's row-streaming kernel for Hopper (jnd_delta.cu's vs_jnd_delta), and
// its launcher. K6 and the K7 probe keep the strip kernel of jnd_delta.cuh.
//
// Replaces videoseal_tpu/kernels/fused_blend.py::fused_jnd_delta
// (_delta_kernel): delta (F,H,W) f32 = sw * heat(lum(img)) * pred, zeros
// outside the image, img (F,H,W,3) u8 or f32 NHWC, pred (F,H,W) f32.
//
// Bound on the H100: device-memory bytes, each input read once and the
// output written once: 3 + 4 + 4 B a pixel on u8 frames, 12 + 4 + 4 on f32
// frames (F=128 at 1080p: 0.872 and 1.585 ms at 3.35 TB/s). The heat's ~85
// f32 operations a pixel take ~0.34 ms at the CUDA cores' 67 TFLOP/s, but
// its sm_90a code runs ~175 instructions a pixel (the IEEE sqrt, log, exp
// and division ~60 of them, the stencil ~30, the staging, luminance and
// addressing the rest): at 4 warp instructions a cycle an SM that is more
// than the u8 frames' bytes take, so on u8 frames the kernel is held by the
// SMs' instruction rate, on f32 frames by bytes (PERF.md has the split).
//
// What the strip kernel did, and what this design does about it:
//  * Each frame row is read once, in 16-byte copies. A block owns one
//    frame, a strip of `rows` output rows and a band of `band` columns
//    (half a 1080p row by default). It streams the strip's raw NHWC rows, plus two
//    halo rows above and below, through a ring of K row stages in shared
//    memory with cp.async (.cg, 16 bytes a thread, zero-filled past the
//    row's ends): the halo rows are read twice per strip, not per 8 rows,
//    and no thread loads a channel value at a time. The prediction's row
//    is staged the same way; the delta goes out in 16-byte stores.
//  * The copies run ahead of the heat, and one barrier a row is the only
//    block-wide wait. Step j starts raw row j + K's copies, computes output
//    row j - 4's delta and raw row j + 1's luminance, then waits on the
//    thread's own copies of row j + 2 (cp.async.wait_group) before the
//    barrier that makes everyone's copies, and the new luminance row,
//    visible to all: the loads of K - 1 rows overlap each row's heat.
//  * The luminance of each raw row is computed once per pixel, in the plain
//    version's order, into a rolling window of NWIN = 6 rows in shared
//    memory (row j of the strip in slot j mod 6). Six slots, not five: a
//    row's luminance is written while the same step reads the five rows of
//    its delta, so one barrier a row suffices.
//  * The heat: a thread owns P = 4 adjacent pixels of a row, the same four
//    for the luminance, so the threads' work is even. It reads the 8 window
//    columns they need as two aligned float4 loads a row, forms each
//    column's vertical sums once, then each pixel's horizontal ones and
//    jnd_heat_sums (jnd_heat.cuh): the additions of jnd_heat_rows in the
//    same order, so the result is the strip kernel's bit for bit. Up to
//    512 threads a block and two blocks an SM cap the registers at 64.
//  * Any H and W in the same kernel: the 16-byte copies run where the
//    frame's base and row pitch are 16-byte aligned (vec_frames) and the
//    planes' where W % 4 == 0 and their bases are aligned (vec_planes).
//    Otherwise the frame's chunks are loaded value by value with masks and
//    the prediction by 4-byte cp.async, into the same stages. A ragged last
//    band, a strip longer than the frame's rest and frames of fewer than 5
//    rows take the same path with the missing rows and columns zero.
//
// HM (jnd_heat.cuh) switches the heat for the split that chip_smoke.py
// times (jnd_rows_split.cu): kHeatCopy writes sw * lum(y, x - 2) + pred (the
// K7 probe's copy), kHeatSums the stencil sums alone; K5 is kHeatNoSqrt.
//
// Shared memory of a block (smem_bytes, copied in the wrapper's
// kernels/fused_blend.py::k5_geometry, which must follow a change here):
// the window, NWIN * (band + 4) floats; K raw stages of 3 * band values and
// HALO_B bytes each side; K + 1 prediction stages of band floats.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "jnd_heat.cuh"

namespace jnd_rows {

constexpr int MAX_NT = 512;    // threads a block at most
constexpr int MAX_BAND = 2048; // columns a block at most (MAX_NT groups of P)
constexpr int P = 4;           // pixels a thread owns in a row
constexpr int NWIN = 6;        // luminance window slots
constexpr int HALO_B = 32;     // bytes a raw stage holds beyond the band on each side

// bytes of one raw row stage: the band's NHWC values and HALO_B each side
__host__ __device__ inline int raw_bytes(int band, int es) { return 3 * es * band + 2 * HALO_B; }

// K raw stages, K + 1 prediction stages (band floats each), the window
__host__ __device__ inline size_t smem_bytes(int band, int es, int stages) {
  return sizeof(float) * NWIN * (band + 4) + (size_t)stages * raw_bytes(band, es) +
         (size_t)(stages + 1) * sizeof(float) * band;
}

// threads a block: one a group of P columns, in whole warps
__host__ __device__ inline int threads_of(int band) { return (band / P + 31) / 32 * 32; }

// K, the raw rows in flight, by frame type: the fastest of 2, 3 and 4 at
// F=128, 1080p on an H100 80GB HBM3 at 700 W (chip_smoke.py): 4 of u8
// frames; 3 of f32 frames, whose 4 fit fewer blocks an SM. Copied in
// kernels/fused_blend.py::K5_STAGES, which must follow a change here.
template <typename T>
constexpr int stages_of() { return sizeof(T) == 1 ? 4 : 3; }

struct Args {
  const void* img;
  const float* pred;
  float* out;
  int H, W, rows, band, bands, vec_frames, vec_planes;
  float c0, c1, c2, sw;
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, of which the first n (0..16) read, the rest
// zero; src must be a valid 16-byte aligned address even where n == 0
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(n) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(n) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lum(const float3 c, float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c.x, r), __fmul_rn(c.y, g)), __fmul_rn(c.z, b));
}

// The luminance of P = 4 adjacent pixels from their staged values at st.
// u8 (12 bytes, 4-byte aligned): byte b goes to the float 2^23 + b, and
// fma(c, 2^23 + b, -c * 2^23) is c * b rounded once, __fmul_rn(c, b) bit for
// bit (cm = -c * 2^23, exact). f32: 48 bytes, 16-byte aligned.
__device__ __forceinline__ void lum4(float (&v)[P], const uint8_t* st, const float3 c,
                                     const float3 cm) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(st);
  const uint32_t wd[3] = {s[0], s[1], s[2]};
  auto prod = [&](float w, float m, int k) {
    const float x = __uint_as_float(__byte_perm(wd[k >> 2], 0x4B000000u, 0x7540u | (k & 3)));
    return __fmaf_rn(w, x, m);
  };
#pragma unroll
  for (int i = 0; i < P; ++i)
    v[i] = __fadd_rn(__fadd_rn(prod(c.x, cm.x, 3 * i), prod(c.y, cm.y, 3 * i + 1)),
                     prod(c.z, cm.z, 3 * i + 2));
}
__device__ __forceinline__ void lum4(float (&v)[P], const float* st, const float3 c,
                                     const float3) {
  const float4* s = reinterpret_cast<const float4*>(st);
  const float4 a = s[0], b = s[1], d = s[2];
  v[0] = lum(c, a.x, a.y, a.z);
  v[1] = lum(c, a.w, b.x, b.y);
  v[2] = lum(c, b.z, b.w, d.x);
  v[3] = lum(c, d.y, d.z, d.w);
}

__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T, int K, int HM = kHeatNoSqrt>
__global__ void __launch_bounds__(MAX_NT, 2) jnd_rows_kernel(const __grid_constant__ Args a) {
  constexpr int ES = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int band = a.band, ld = band + 4, ng = band / P;
  const int rb = raw_bytes(band, ES), nch = rb / 16;   // bytes, 16-byte chunks of a row
  float* win = reinterpret_cast<float*>(smem);
  unsigned char* raw = smem + sizeof(float) * NWIN * ld;
  float* pst = reinterpret_cast<float*>(raw + (size_t)K * rb);

  const int strip = blockIdx.x / a.bands;
  const int x0 = (blockIdx.x - strip * a.bands) * band;
  const int y0 = strip * a.rows;
  const int n = min(a.rows, a.H - y0);   // output rows of the strip
  const int tid = threadIdx.x, nt = blockDim.x;
  const int H = a.H, W = a.W;
  const size_t fpix = (size_t)blockIdx.y * H * W;
  const bool vec_frames = a.vec_frames, vec_planes = a.vec_planes;
  const float3 cw = make_float3(a.c0, a.c1, a.c2);
  const float3 cm = make_float3(-a.c0 * 8388608.f, -a.c1 * 8388608.f, -a.c2 * 8388608.f);
  const float sw = a.sw;

  // The thread's P pixels (its luminance, its delta and its prediction
  // copies): band columns P * tid .., image columns x ..
  const bool has_g = tid < ng;
  const int x = x0 + P * tid;
  const bool has_x = has_g && x < W;
  // the frame's rows as bytes, from the row's byte at a raw stage's first
  const int row_bytes = 3 * ES * W;
  const unsigned char* frame =
      reinterpret_cast<const unsigned char*>(a.img) + fpix * 3 * ES + 3 * ES * x0 - HALO_B;
  const int xb0 = 3 * ES * x0 - HALO_B;   // the row's byte at a raw stage's first
  const float* pred0 = a.pred;
  const float* pcol = pred0 + fpix + x;   // the prediction's column x, row 0
  float* ocol = a.out + fpix + x;

  // Group j of copies: raw row y0 - 2 + j (0 <= j <= n + 3) into the raw
  // stage at byte ro, its 16-byte chunks spread over the threads, and for
  // j >= 4 the prediction's row y0 + j - 4 into the stage at float po, each
  // thread the 16 bytes of its own P pixels. A thread's first chunk (c =
  // tid; more only where a row has more chunks than the block threads)
  // starts at byte eb0 of the row, of which nb0 bytes lie in the row.
  const int eb0 = xb0 + 16 * tid;
  const int nb0 = eb0 < 0 ? 0 : min(16, max(0, row_bytes - eb0));
  auto fetch = [&](int j, int ro, int po) {
    const int gy = y0 - 2 + j;
    if (j <= n + 3 && gy >= 0 && gy < H) {
      unsigned char* dst = raw + ro;
      const unsigned char* row = frame + (size_t)gy * row_bytes;
      if (vec_frames && tid < nch)
        cp16(dst + 16 * tid, nb0 ? row + 16 * tid : row - xb0, nb0);
      for (int c = vec_frames ? tid + nt : tid; c < nch; c += nt) {
        const int eb = xb0 + 16 * c;   // byte offset in the row, a multiple of 16
        if (vec_frames) {
          const int nb = eb < 0 ? 0 : min(16, max(0, row_bytes - eb));
          cp16(dst + 16 * c, nb ? row + 16 * c : row - xb0, nb);
        } else {
          T* d = reinterpret_cast<T*>(dst + 16 * c);
          const T* r = reinterpret_cast<const T*>(row - xb0);
#pragma unroll
          for (int k = 0; k < 16 / ES; ++k) {
            const int off = eb + k * ES;
            d[k] = (off >= 0 && off < row_bytes) ? r[off / ES] : T(0);
          }
        }
      }
    }
    if (has_g && j >= 4 && j - 4 < n) {
      float* dst = pst + po + P * tid;
      const float* src = pcol + (size_t)(y0 + j - 4) * W;
      if (vec_planes) {
        cp16(dst, has_x ? src : pred0, has_x ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i)
          cp4(dst + i, x + i < W ? src + i : pred0, x + i < W ? 4 : 0);
      }
    }
    commit();
  };

  // The luminance of raw row y0 - 2 + j (raw stage at byte ro) into the
  // window row at float wo (window column c holds band column c - 2): each
  // thread its own P pixels, the first and last thread the two halo columns
  // on their side.
  auto convert = [&](int j, int ro, int wo) {
    const int gy = y0 - 2 + j;
    const bool in = gy >= 0 && gy < H;
    const T* st = reinterpret_cast<const T*>(raw + ro + HALO_B);
    float* wr = win + wo + 2;   // band column 0
    if (has_g) {
      float v[P] = {0.f, 0.f, 0.f, 0.f};
      if (in) lum4(v, st + 3 * P * tid, cw, cm);
      *reinterpret_cast<float2*>(wr + P * tid) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(wr + P * tid + 2) = make_float2(v[2], v[3]);
    }
    if (tid == 0 || tid == nt - 1) {
      const int p = tid == 0 ? -2 : band;   // the two halo columns p, p + 1
      float2 v = make_float2(0.f, 0.f);
      if (in) {
        const T* s = st + 3 * p;
        v = make_float2(lum(cw, to_f(s[0]), to_f(s[1]), to_f(s[2])),
                        lum(cw, to_f(s[3]), to_f(s[4]), to_f(s[5])));
      }
      *reinterpret_cast<float2*>(wr + p) = v;
    }
  };

  // The delta of output row y0 + j - 4 from the window rows at floats
  // wrow[0..4] (rows j - 4 .. j) and the prediction's stage at float po.
  auto heat = [&](int j, const int (&wrow)[5], int po) {
    // window columns 4 tid .. 4 tid + 7: band columns x - 2 .. x + 5 (m = 0..7)
    float q[5][8];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float* r = win + wrow[k] + P * tid;
      const float4 lo = *reinterpret_cast<const float4*>(r);
      const float4 hi = *reinterpret_cast<const float4*>(r + 4);
      q[k][0] = lo.x, q[k][1] = lo.y, q[k][2] = lo.z, q[k][3] = lo.w;
      q[k][4] = hi.x, q[k][5] = hi.y, q[k][6] = hi.z, q[k][7] = hi.w;
    }
    float v5[8], v3[8], t[8], sd[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      v5[m] = (((q[0][m] + q[1][m]) + q[2][m]) + q[3][m]) + q[4][m];
      v3[m] = (q[1][m] + q[2][m]) + q[3][m];
      t[m] = __fadd_rn(q[1][m] + 2.f * q[2][m], q[3][m]);
      sd[m] = q[1][m] - q[3][m];
    }
    const float4 pv = *reinterpret_cast<const float4*>(pst + po + P * tid);
    const float pr[P] = {pv.x, pv.y, pv.z, pv.w};
    float o[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float c5 = (((v5[i] + v5[i + 1]) + v5[i + 2]) + v5[i + 3]) + v5[i + 4];
      const float c3 = (v3[i + 1] + v3[i + 2]) + v3[i + 3];
      const float gy = __fadd_rn(sd[i + 1] + 2.f * sd[i + 2], sd[i + 3]);
      if constexpr (HM == kHeatCopy) {   // the split's copy: sw * lum(y, x - 2) + pred
        o[i] = __fadd_rn(__fmul_rn(sw, q[2][i]), pr[i]);
      } else {
        const float h = jnd_heat_sums<HM>(c5, c3, q[2][i + 2], t[i + 1], t[i + 3], gy);
        o[i] = __fmul_rn(__fmul_rn(sw, h), pr[i]);
      }
    }
    float* op = ocol + (size_t)(y0 + j - 4) * W;
    if (vec_planes) {
      *reinterpret_cast<float4*>(op) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (x + i < W) op[i] = o[i];
    }
  };

  // Step j: fetch group j + K; the delta of row y0 + j - 4; the luminance
  // of raw row j + 1; wait for this thread's copies of group j + 2; one
  // barrier, after which every thread's copies of group j + 2 and window
  // row j + 1 are visible to all. The stages rotate: raw ri (fetch, slot j %
  // K) and rc (convert, (j + 1) % K) in bytes; the prediction's pi (fetch,
  // (j + K) % (K + 1)) and ph (heat, j % (K + 1)) in floats; the window's
  // wc (convert, (j + 1) % NWIN) and wrow (heat, rows j - 4 .. j) in floats.
  const int pstage = ng * P;
#pragma unroll
  for (int j = 0; j < K; ++j) fetch(j, j * rb, j * pstage);
  wait_group<K - 1>();
  __syncthreads();
  convert(0, 0, 0);
  wait_group<K - 2>();
  __syncthreads();
  int ri = 0, rc = rb, pi = K * pstage, ph = 0, wc = ld;
  int wrow[5] = {2 * ld, 3 * ld, 4 * ld, 5 * ld, 0};
  for (int j = 0; j <= n + 3; ++j) {
    fetch(j + K, ri, pi);   // raw slot ri: row j, converted before the last barrier
    if (j >= 4 && has_x) heat(j, wrow, ph);
    if (j < n + 3) convert(j + 1, rc, wc);
    ri = rc;
    rc = rc + rb == K * rb ? 0 : rc + rb;
    pi = pi + pstage == (K + 1) * pstage ? 0 : pi + pstage;
    ph = ph + pstage == (K + 1) * pstage ? 0 : ph + pstage;
#pragma unroll
    for (int k = 0; k < 4; ++k) wrow[k] = wrow[k + 1];
    wrow[4] = wc;
    wc = wc + ld == NWIN * ld ? 0 : wc + ld;
    wait_group<K - 2>();
    __syncthreads();
  }
}

// The host's checks of what the wrapper computed: the band a multiple of
// 16 up to MAX_BAND, the vector paths only where the alignment holds.
inline bool args_ok(const Args& a, int es) {
  const bool band_ok = a.band >= 16 && a.band % 16 == 0 && a.band <= MAX_BAND;
  const bool vf = ((uintptr_t)a.img & 15u) == 0 && ((size_t)a.W * 3 * es) % 16 == 0;
  const bool vp = ((uintptr_t)a.pred & 15u) == 0 && ((uintptr_t)a.out & 15u) == 0 &&
                  a.W % 4 == 0;
  return band_ok && a.rows >= 1 && a.W >= 1 && a.bands == (a.W + a.band - 1) / a.band &&
         (!a.vec_frames || vf) && (!a.vec_planes || vp);
}

template <typename T, int HM = kHeatNoSqrt>
int launch(const Args& a, int F, void* stream) {
  if (!args_ok(a, sizeof(T))) return (int)cudaErrorInvalidValue;
  constexpr int K = stages_of<T>();
  const size_t smem = smem_bytes(a.band, sizeof(T), K);
  auto kern = jnd_rows_kernel<T, K, HM>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.H + a.rows - 1) / a.rows * a.bands, F);
  kern<<<grid, threads_of(a.band), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// What the card reports for K5's instance at `band` columns: info[0]
// registers a thread, [1] local-memory bytes a thread (spills), [2] dynamic
// shared memory and [3] threads a block, [4] blocks an SM.
template <typename T>
int info(int band, int* info) {
  constexpr int K = stages_of<T>();
  auto kern = jnd_rows_kernel<T, K>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(band, sizeof(T), K);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads_of(band), smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = (int)smem;
  info[3] = threads_of(band);
  info[4] = per_sm;
  return 0;
}

}  // namespace jnd_rows
