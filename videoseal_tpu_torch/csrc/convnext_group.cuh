// K3: k consecutive ConvNeXtV2 blocks in one launch, on K2's parts
// (convnext_block.cuh). Its bf16 and f32 instances build from two sources,
// convnext_group.cu and convnext_group_f32.cu, in parallel.
//
// K3 replaces videoseal_tpu/kernels/convnext_block.py::convnext_blocks_fused
// (Pallas body _kernel_multi): k blocks in one call, every intermediate
// rounded to bf16 and re-padded with its 3-pixel zero halo, the last block
// in x's dtype.
// Design: one persistent cooperative launch (cudaLaunchCooperativeKernel,
// grid sized to what is co-resident) walks the (tile, frame) items of the
// 2k phases a0, b0, a1, b1, ... in a loop, with a grid barrier between
// phases: GRN's per-frame reduction still needs all of a frame's part (a)
// before its part (b), and block j+1's depthwise halo needs block j's
// neighbouring tiles. The intermediates live in one or two bf16 ping-pong
// buffers whose zero halo the wrapper allocates and the kernel never writes.
// Bound as for K2: the pointwise products on the tensor cores; grouping
// saves one read of x and one write of the output per block and k-1
// launches, not the hidden round trip. Later speed work: a thread-block
// cluster could keep a stage-2/3 frame's hidden activation in distributed
// shared memory, so that it never reaches device memory.

#pragma once

#include <cooperative_groups.h>

#include "convnext_block.cuh"

namespace {

namespace cg = cooperative_groups;
constexpr int MAXK = 4;  // blocks per K3 launch

struct BlockW {  // one block's parameters, in block_params' layout
  const float* dw;
  const float* dwb;
  const float* lnw;
  const float* lnb;
  const bf16* w1;
  const float* b1;
  const float* gamma;
  const float* beta;
  const bf16* w2;
  const float* b2;
};
struct Group {
  BlockW b[MAXK];
};

template <typename TIn>
__device__ __forceinline__ void group_a(unsigned char* smem, const TIn* src, const BlockW& w,
                                        bf16* hmid, float* part, int H, int W, int C, int P,
                                        int ntile, int items) {
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    __syncthreads();  // the previous item is done with shared memory
    const int f = it / ntile;
    block_a<TIn, kDwPerDy, kActErf, false>(smem, src, w.dw, w.dwb, w.lnw, w.lnb, w.w1, w.b1,
                                           hmid, part, H, W, C, P, it - f * ntile, f, ntile);
  }
}

template <typename TIn, typename TOut>
__device__ __forceinline__ void group_b(unsigned char* smem, const TIn* src, TOut* dst,
                                        int opad, const BlockW& w, const bf16* hmid,
                                        const float* part, int H, int W, int C, int P,
                                        int ntile, int items) {
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    __syncthreads();
    const int f = it / ntile;
    block_b<TIn, TOut>(smem, hmid, part, w.gamma, w.beta, w.w2, w.b2, src, dst, H, W, C, P,
                       opad, it - f * ntile, f, ntile);
  }
}

// xpad (B, H+6, W+6, C) in T; pp0, pp1 (B, H+6, W+6, C) bf16 with a zero
// halo (pp1 used for k >= 3); out (B, H, W, C) in T.
template <typename T>
__global__ void __launch_bounds__(NT)
cnx_group(const T* __restrict__ xpad, bf16* __restrict__ pp0, bf16* __restrict__ pp1,
          T* __restrict__ out, bf16* __restrict__ hmid, float* __restrict__ part, Group g,
          int k, int B, int H, int W, int C, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int ntile = H * W / P, items = ntile * B;
  for (int j = 0; j < k; ++j) {
    const BlockW& w = g.b[j];
    bf16* dst = (j & 1) ? pp1 : pp0;        // block j writes here (unless last)
    const bf16* src = (j & 1) ? pp0 : pp1;  // what block j-1 wrote
    const bool last = j == k - 1;
    if (j == 0) group_a(smem, xpad, w, hmid, part, H, W, C, P, ntile, items);
    else group_a(smem, src, w, hmid, part, H, W, C, P, ntile, items);
    grid.sync();
    if (j == 0) {
      if (last) group_b(smem, xpad, out, 0, w, hmid, part, H, W, C, P, ntile, items);
      else group_b(smem, xpad, dst, 3, w, hmid, part, H, W, C, P, ntile, items);
    } else {
      if (last) group_b(smem, src, out, 0, w, hmid, part, H, W, C, P, ntile, items);
      else group_b(smem, src, dst, 3, w, hmid, part, H, W, C, P, ntile, items);
    }
    if (!last) grid.sync();
  }
}

template <typename T>
int launch_group(const void* xpad, void* pp0, void* pp1, void* out, void* hmid, void* part,
                 const void* const* wptrs, int k, int B, int H, int W, int C, int P,
                 void* stream) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  Group g = {};
  for (int j = 0; j < k; ++j) {
    const void* const* q = wptrs + 10 * j;
    g.b[j] = BlockW{(const float*)q[0], (const float*)q[1], (const float*)q[2],
                    (const float*)q[3], (const bf16*)q[4],  (const float*)q[5],
                    (const float*)q[6], (const float*)q[7], (const bf16*)q[8],
                    (const float*)q[9]};
  }
  const size_t a = smem_a(P, C), b = smem_b(P, C);
  const size_t smem = a > b ? a : b;
  auto kern = cnx_group<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (e != cudaSuccess) return (int)e;
  const int items = H * W / P * B;
  const int grid = per_sm * sms < items ? per_sm * sms : items;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  const T* x = (const T*)xpad;
  bf16 *p0 = (bf16*)pp0, *p1 = (bf16*)pp1, *h = (bf16*)hmid;
  T* o = (T*)out;
  float* pt = (float*)part;
  void* args[] = {(void*)&x, (void*)&p0, (void*)&p1, (void*)&o, (void*)&h, (void*)&pt,
                  (void*)&g, (void*)&k, (void*)&B, (void*)&H, (void*)&W, (void*)&C,
                  (void*)&P};
  e = cudaLaunchCooperativeKernel((const void*)kern, grid, NT, args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#define VS_ENTRY_GROUP(NAME, T)                                                             \
  extern "C" int NAME(const void* xpad, void* pp0, void* pp1, void* out, void* hmid,        \
                      void* part, const void* wptrs, int k, int B, int H, int W, int C,     \
                      int P, void* stream) {                                                \
    return launch_group<T>(xpad, pp0, pp1, out, hmid, part, (const void* const*)wptrs, k, B, \
                           H, W, C, P, stream);                                             \
  }
