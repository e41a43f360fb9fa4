// K2, part 1 of 4 (dwln): the ConvNeXtV2 block's depthwise 7x7 conv, its
// bias and the channel LayerNorm, NHWC.
//
// K2 replaces videoseal_tpu/kernels/convnext_block.py::convnext_block_fused
// (Pallas body _block_math); this part is its dw + LN prologue. The block's
// other parts are in convnext_pw.cu.
//
// x (B, H, W, C), f32 or bf16, is read directly: the 3-pixel halo outside
// the frame is zero (no padded copy). Out: A (B*H*W, C) bf16, row-major, the
// LN output rounded to bf16, which pw1 reads as its A operand.
//
// Bound on the H100: bytes (x read once, A written once; 49 multiply-adds
// per output, far below the f32 rate). Design: one block per (frame, image
// row), no barrier inside the depthwise phase. A thread takes one
// channel of an 8-pixel row segment: for each of the 7 rows of taps it loads
// the 14 inputs the segment needs (through L1, where the neighbouring
// segments' and rows' loads land too; a warp reads 32 consecutive channels;
// only segments at the frame's edge test each pixel) and its 7 taps, and
// sums the 8 outputs in the per-dy order of the plain version
// (dw_plain(form="perdy")) with the products fused into the row sums (FMA,
// as the earlier kernel did; the plain version rounds each product), then
// adds the bias. The f32 results of the row, all C channels, wait in
// shared memory; then one warp per pixel takes the LN's mean and variance
// (two passes over the row) and writes two channels per lane and step as
// bf16 pairs. Timed on the H100 and not kept: 16-channel slices staged in
// shared memory with a barrier per slice (latency-bound at the small-W
// stages), the taps staged in shared memory, two channels a thread, 4- or
// 16-pixel segments, and two or four rows a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;  // threads per block
constexpr int SEG = 8;   // outputs along a row per thread

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// (v - mu) * rs * w + b, each step rounded as in the plain version
__device__ __forceinline__ float ln(float v, float mu, float rs, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rs), w), b);
}

template <typename T>
__global__ void __launch_bounds__(NT)
cnx_dwln(const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ dwb,
         const float* __restrict__ lnw, const float* __restrict__ lnb, bf16* __restrict__ a,
         int H, int W, int C) {
  extern __shared__ __align__(16) float acc[];  // (W, C) f32 dw output + bias
  const int f = blockIdx.y, y = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nseg = (W + SEG - 1) / SEG;
  const T* xf = x + (size_t)f * H * W * C;

  // depthwise 7x7 + bias: items (segment, channel), channel fastest
  for (int it = tid; it < nseg * C; it += NT) {
    const int c = it % C, x0 = (it / C) * SEG;
    // interior segments load without per-pixel tests; rows outside the frame
    // add nothing
    const bool inner = x0 >= 3 && x0 + SEG + 3 <= W;
    float sum[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) sum[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      const int yy = y + dy - 3;
      if (yy < 0 || yy >= H) continue;
      const T* src = xf + ((ptrdiff_t)yy * W + x0 - 3) * C + c;
      float in[SEG + 6], w[7];
      if (inner) {
#pragma unroll
        for (int j = 0; j < SEG + 6; ++j) in[j] = to_f(src[(ptrdiff_t)j * C]);
      } else {
#pragma unroll
        for (int j = 0; j < SEG + 6; ++j) {
          const int xx = x0 + j - 3;
          in[j] = xx >= 0 && xx < W ? to_f(src[(ptrdiff_t)j * C]) : 0.f;
        }
      }
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) w[dx] = dw[(dy * 7 + dx) * C + c];
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        float prt = in[j] * w[0];
#pragma unroll
        for (int dx = 1; dx < 7; ++dx) prt = fmaf(in[j + dx], w[dx], prt);
        sum[j] += prt;
      }
    }
    const float bias = dwb[c];
#pragma unroll
    for (int j = 0; j < SEG; ++j)
      if (x0 + j < W) acc[(size_t)(x0 + j) * C + c] = sum[j] + bias;
  }
  __syncthreads();

  // channel LN, one warp per pixel, a channel pair per lane and step
  const float invc = 1.f / C;
  const int C2 = C / 2;
  for (int q = warp; q < W; q += NT / 32) {
    const float2* row = (const float2*)(acc + (size_t)q * C);
    float s = 0.f;
    for (int g = lane; g < C2; g += 32) {
      const float2 v = row[g];
      s += v.x + v.y;
    }
    const float mu = warp_sum(s) * invc;
    float var = 0.f;
    for (int g = lane; g < C2; g += 32) {
      const float2 v = row[g];
      const float d0 = v.x - mu, d1 = v.y - mu;
      var += d0 * d0 + d1 * d1;
    }
    const float rstd = rsqrtf(warp_sum(var) * invc + 1e-6f);
    __nv_bfloat162* dst = (__nv_bfloat162*)(a + (((size_t)f * H + y) * W + q) * C);
    for (int g = lane; g < C2; g += 32) {
      const float2 v = row[g];
      dst[g] = __floats2bfloat162_rn(ln(v.x, mu, rstd, lnw[2 * g], lnb[2 * g]),
                                     ln(v.y, mu, rstd, lnw[2 * g + 1], lnb[2 * g + 1]));
    }
  }
}

template <typename T>
int launch_dwln(const void* x, const void* dw, const void* dwb, const void* lnw, const void* lnb,
                void* a, int B, int H, int W, int C, void* stream) {
  if (C % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)W * C;
  auto kern = cnx_dwln<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B);
  kern<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)dw, (const float*)dwb, (const float*)lnw, (const float*)lnb,
      (bf16*)a, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vs_cnx_dwln_f32(const void* x, const void* dw, const void* dwb, const void* lnw,
                               const void* lnb, void* a, int B, int H, int W, int C,
                               void* stream) {
  return launch_dwln<float>(x, dw, dwb, lnw, lnb, a, B, H, W, C, stream);
}

extern "C" int vs_cnx_dwln_bf16(const void* x, const void* dw, const void* dwb, const void* lnw,
                                const void* lnb, void* a, int B, int H, int W, int C,
                                void* stream) {
  return launch_dwln<__nv_bfloat16>(x, dw, dwb, lnw, lnb, a, B, H, W, C, stream);
}
