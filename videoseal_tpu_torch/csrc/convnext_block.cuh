// The ConvNeXtV2 block's two parts as device functions, the kernels that
// launch each part over a (tile, frame) grid, and their launchers: shared by
// K2 and K3 (convnext_block.cu) and the K8 probe (convnext_probe.cu).
//
// Design of a block (K2 replaces
// videoseal_tpu/kernels/convnext_block.py::convnext_block_fused, Pallas body
// _block_math):
//   dw7x7 (f32 sums) + bias -> channel LN (eps 1e-6) -> pw1 (bf16 in, f32 sums)
//   + bias -> erf GELU -> bf16 -> GRN -> bf16 -> pw2 + bias -> + x (f32).
// The TPU kept a whole frame in 16 MB of VMEM. A stage-0 frame does not fit
// 227 KB of shared memory, and GRN needs a reduction over all H*W pixels of
// a frame before pw2, so the block is split in two parts:
//   (a) per (frame, tile of P pixels): dw7x7 (3-pixel halo from the
//       zero-padded input), LN, pw1 on bf16 wmma fragments with f32
//       accumulation, GELU, the bf16 hidden stored to device memory, and per
//       tile partial sums of hidden^2 (f32 over the bf16-rounded values);
//   (b) per (frame, tile): the partials reduced in a fixed order to
//       gx = sqrt(max(sum, 1e-12)), nx = gx / (mean_c gx + 1e-6), GRN
//       applied to K-chunks of the hidden, rounded to bf16, pw2 on wmma
//       fragments, bias and the f32 residual.
// Partials plus a fixed-order reduction keep the result deterministic.
// The pw weights stay in their torch Linear layout (out, in), which is the
// column-major B operand, and are streamed in 16-wide K slices from L2.
//
// Part (a) is a template over the depthwise form (per-dy partials, one tap
// chain, dx-outer chain, bf16 taps and sums), the activation (erf, none,
// tanh, sigmoid) and a depthwise-only flag that writes the bf16 dw output
// (without its bias) and stops: the K8 probe's variants. K2 is the instance
// (per-dy, erf, full block).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int KC = 64;       // pw2 K chunk staged in shared memory
constexpr int MAXT = 12;     // pw2 output tiles per warp: (P/16) * (C/16) <= 96

enum DwForm { kDwPerDy = 0, kDwTaps = 1, kDwShift = 2, kDwBf16 = 3 };
enum Act { kActErf = 0, kActNone = 1, kActTanh = 2, kActSigmoid = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline size_t smem_a(int P, int C) { return (size_t)P * C * (4 + 2) + NW * 32 * 16 * 4; }
inline size_t smem_b(int P, int C) { return (size_t)4 * C * 4 + 32 * 4 + (size_t)P * KC * 2 + NW * 256 * 4; }

// depthwise 7x7 sum of one (pixel, channel); base points at the padded
// input's (y, x) for output pixel (y, x), i.e. the top-left tap
template <int DW, typename T>
__device__ __forceinline__ float dw_sum(const T* __restrict__ base,
                                        const float* __restrict__ dw, int c, int Wp, int C) {
  if constexpr (DW == kDwPerDy) {  // per-row partial sums
    float acc = 0.f;
    for (int dy = 0; dy < 7; ++dy) {
      float prt = 0.f;
#pragma unroll
      for (int dx = 0; dx < 7; ++dx)
        prt += to_f(base[((size_t)dy * Wp + dx) * C]) * dw[(dy * 7 + dx) * C + c];
      acc += prt;
    }
    return acc;
  } else if constexpr (DW == kDwTaps) {  // one chain, dy outer
    float acc = 0.f;
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx)
        acc += to_f(base[((size_t)dy * Wp + dx) * C]) * dw[(dy * 7 + dx) * C + c];
    return acc;
  } else if constexpr (DW == kDwShift) {  // one chain, dx outer
    float acc = 0.f;
    for (int dx = 0; dx < 7; ++dx)
#pragma unroll
      for (int dy = 0; dy < 7; ++dy)
        acc += to_f(base[((size_t)dy * Wp + dx) * C]) * dw[(dy * 7 + dx) * C + c];
    return acc;
  } else {  // bf16 products and sums, each rounded (_rn: no contraction into an FMA)
    bf16 acc = __float2bfloat16(0.f);
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        const bf16 t = __hmul_rn(__float2bfloat16(to_f(base[((size_t)dy * Wp + dx) * C])),
                                 __float2bfloat16(dw[(dy * 7 + dx) * C + c]));
        acc = __hadd_rn(acc, t);
      }
    return __bfloat162float(acc);
  }
}

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if constexpr (ACT == kActErf) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  else if constexpr (ACT == kActTanh)
    return 0.5f * v * (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
  else if constexpr (ACT == kActSigmoid) return v / (1.f + expf(-1.702f * v));
  else return v;
}

// Part (a) of frame f, tile `tile` of ntile. xpad (B, H+6, W+6, C) in T.
// DWONLY: hmid is the (B, H*W, C) bf16 dw output instead.
template <typename T, int DW, int ACT, bool DWONLY>
__device__ __forceinline__ void block_a(unsigned char* smem, const T* __restrict__ xpad,
                                        const float* __restrict__ dw,
                                        const float* __restrict__ dwb,
                                        const float* __restrict__ lnw,
                                        const float* __restrict__ lnb,
                                        const bf16* __restrict__ w1,
                                        const float* __restrict__ b1, bf16* __restrict__ hmid,
                                        float* __restrict__ part, int H, int W, int C, int P,
                                        int tile, int f, int ntile) {
  float* accf = (float*)smem;                 // (P, C) dw output
  bf16* A = (bf16*)(accf + P * C);            // (P, C) LN output, bf16
  float* stage = (float*)(A + P * C);         // per warp (32, 16) f32

  const int HW = H * W, Wp = W + 6, K4 = 4 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* xf = xpad + (size_t)f * (H + 6) * Wp * C;

  // depthwise 7x7, then the bias
  for (int idx = tid; idx < P * C; idx += NT) {
    const int p = idx / C, c = idx - p * C;
    const int pix = tile * P + p;
    const int y = pix / W, x = pix - y * W;
    const float acc = dw_sum<DW>(xf + ((size_t)y * Wp + x) * C + c, dw, c, Wp, C);
    if constexpr (DWONLY)
      hmid[((size_t)f * HW + tile * P) * C + idx] = __float2bfloat16(acc);
    else
      accf[idx] = acc + dwb[c];
  }
  if constexpr (DWONLY) return;
  __syncthreads();

  // channel LayerNorm, one warp per pixel, two passes
  for (int p = warp; p < P; p += NW) {
    const float* row = accf + p * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mu;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / C + 1e-6f);
    for (int c = lane; c < C; c += 32)
      A[p * C + c] = __float2bfloat16((row[c] - mu) * rs * lnw[c] + lnb[c]);
  }
  __syncthreads();

  // pw1: each warp owns 16-wide output column tiles, all P rows
  float* st = stage + warp * 32 * 16;
  const bool two = P == 32;
  for (int n = warp; n < K4 / 16; n += NW) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
    wmma::fill_fragment(acc0, 0.f);
    wmma::fill_fragment(acc1, 0.f);
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, w1 + (size_t)n * 16 * C + k, C);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
      wmma::load_matrix_sync(afr, A + k, C);
      wmma::mma_sync(acc0, afr, bfr, acc0);
      if (two) {
        wmma::load_matrix_sync(afr, A + 16 * C + k, C);
        wmma::mma_sync(acc1, afr, bfr, acc1);
      }
    }
    wmma::store_matrix_sync(st, acc0, 16, wmma::mem_row_major);
    if (two) wmma::store_matrix_sync(st + 256, acc1, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < P * 16; e += 32) {
      const int r = e >> 4, col = n * 16 + (e & 15);
      const bf16 hb = __float2bfloat16(act<ACT>(st[e] + b1[col]));
      hmid[((size_t)f * HW + tile * P + r) * K4 + col] = hb;
      st[e] = __bfloat162float(hb);
    }
    __syncwarp();
    if (lane < 16) {
      float s = 0.f;
      for (int r = 0; r < P; ++r) {
        const float v = st[r * 16 + lane];
        s += v * v;
      }
      part[((size_t)f * ntile + tile) * K4 + n * 16 + lane] = s;
    }
    __syncwarp();
  }
}

// Part (b) of frame f, tile `tile`. The residual comes from xpad (B, H+6,
// W+6, C) in TIn; out is (B, H+2*opad, W+2*opad, C) in TOut, written only
// inside its opad-pixel border.
template <typename TIn, typename TOut>
__device__ __forceinline__ void block_b(unsigned char* smem, const bf16* __restrict__ hmid,
                                        const float* __restrict__ part,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        const bf16* __restrict__ w2,
                                        const float* __restrict__ b2,
                                        const TIn* __restrict__ xpad, TOut* __restrict__ out,
                                        int H, int W, int C, int P, int opad, int tile, int f,
                                        int ntile) {
  const int K4 = 4 * C;
  float* gn = (float*)smem;          // (4C) gamma * nx
  float* red = gn + K4;              // (32) block reduction
  bf16* A = (bf16*)(red + 32);       // (P, KC) GRN output chunk, bf16
  float* stage = (float*)(A + P * KC);  // per warp (16, 16) f32

  const int HW = H * W, Wp = W + 6;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // GRN statistics of the whole frame from the per-tile partials
  float local = 0.f;
  for (int ch = tid; ch < K4; ch += NT) {
    float s = 0.f;
    for (int t = 0; t < ntile; ++t) s += part[((size_t)f * ntile + t) * K4 + ch];
    const float g = sqrtf(fmaxf(s, 1e-12f));
    gn[ch] = g;
    local += g;
  }
  local = warp_sum(local);
  if (lane == 0) red[warp] = local;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w];
    red[NW] = s;
  }
  __syncthreads();
  const float inv = 1.f / (red[NW] / K4 + 1e-6f);
  for (int ch = tid; ch < K4; ch += NT) gn[ch] = gamma[ch] * (gn[ch] * inv);
  __syncthreads();

  // pw2 over K chunks; output tiles (P/16) x (C/16) spread over the warps
  const int MT = P / 16, ntl = MT * (C / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXT];
#pragma unroll
  for (int i = 0; i < MAXT; ++i) wmma::fill_fragment(acc[i], 0.f);
  const bf16* hb = hmid + ((size_t)f * HW + tile * P) * K4;
  for (int k0 = 0; k0 < K4; k0 += KC) {
    for (int idx = tid; idx < P * KC; idx += NT) {
      const int r = idx / KC, ch = k0 + idx - r * KC;
      const float h = __bfloat162float(hb[(size_t)r * K4 + ch]);
      A[idx] = __float2bfloat16(gn[ch] * h + beta[ch] + h);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      const int t = warp + i * NW;
      if (t < ntl) {
        const int m = t % MT, n = t / MT;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
          wmma::load_matrix_sync(afr, A + m * 16 * KC + kk, KC);
          wmma::load_matrix_sync(bfr, w2 + (size_t)n * 16 * K4 + k0 + kk, K4);
          wmma::mma_sync(acc[i], afr, bfr, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  // bias + residual epilogue
  float* st = stage + warp * 256;
  const TIn* xf = xpad + (size_t)f * (H + 6) * Wp * C;
  const int Wo = W + 2 * opad;
  TOut* of = out + (size_t)f * (H + 2 * opad) * Wo * C;
#pragma unroll
  for (int i = 0; i < MAXT; ++i) {
    const int t = warp + i * NW;
    if (t < ntl) {
      const int m = t % MT, n = t / MT;
      wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int pix = tile * P + m * 16 + (e >> 4);
        const int col = n * 16 + (e & 15);
        const int y = pix / W, x = pix - y * W;
        const float res = to_f(xf[((size_t)(y + 3) * Wp + x + 3) * C + col]);
        of[((size_t)(y + opad) * Wo + x + opad) * C + col] =
            from_f<TOut>((st[e] + b2[col]) + res);
      }
      __syncwarp();
    }
  }
}

template <typename T, int DW, int ACT, bool DWONLY>
__global__ void __launch_bounds__(NT)
cnx_block_a(const T* __restrict__ xpad, const float* __restrict__ dw,
            const float* __restrict__ dwb, const float* __restrict__ lnw,
            const float* __restrict__ lnb, const bf16* __restrict__ w1,
            const float* __restrict__ b1, bf16* __restrict__ hmid,
            float* __restrict__ part, int H, int W, int C, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  block_a<T, DW, ACT, DWONLY>(smem, xpad, dw, dwb, lnw, lnb, w1, b1, hmid, part, H, W, C, P,
                              blockIdx.x, blockIdx.y, gridDim.x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
cnx_block_b(const bf16* __restrict__ hmid, const float* __restrict__ part,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            const bf16* __restrict__ w2, const float* __restrict__ b2,
            const T* __restrict__ xpad, T* __restrict__ out, int H, int W, int C, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  block_b<T, T>(smem, hmid, part, gamma, beta, w2, b2, xpad, out, H, W, C, P, 0, blockIdx.x,
                blockIdx.y, gridDim.x);
}

template <typename T, int DW = kDwPerDy, int ACT = kActErf, bool DWONLY = false>
int launch_a(const void* xpad, const void* dw, const void* dwb, const void* lnw,
             const void* lnb, const void* w1, const void* b1, void* hmid, void* part, int B,
             int H, int W, int C, int P, void* stream) {
  const size_t smem = smem_a(P, C);
  auto kern = cnx_block_a<T, DW, ACT, DWONLY>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(H * W / P, B);
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)xpad, (const float*)dw, (const float*)dwb, (const float*)lnw,
      (const float*)lnb, (const bf16*)w1, (const float*)b1, (bf16*)hmid, (float*)part, H, W,
      C, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b(const void* hmid, const void* part, const void* gamma, const void* beta,
             const void* w2, const void* b2, const void* xpad, void* out, int B, int H, int W,
             int C, int P, void* stream) {
  const size_t smem = smem_b(P, C);
  cudaFuncSetAttribute(cnx_block_b<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(H * W / P, B);
  cnx_block_b<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)hmid, (const float*)part, (const float*)gamma, (const float*)beta,
      (const bf16*)w2, (const float*)b2, (const T*)xpad, (T*)out, H, W, C, P);
  return (int)cudaGetLastError();
}

}  // namespace
