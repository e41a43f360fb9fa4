// K3: k consecutive ConvNeXtV2 blocks in one launch, on K2's parts (the
// device functions of convnext_dwln.cuh and convnext_pw.cuh). Its bf16 and
// f32 instances build from two sources, convnext_group.cu and
// convnext_group_f32.cu, in parallel.
//
// K3 replaces videoseal_tpu/kernels/convnext_block.py::convnext_blocks_fused
// (Pallas body _kernel_multi): k blocks in one call, every intermediate
// rounded to bf16, the last block in x's dtype.
// Design: one persistent cooperative launch (cudaLaunchCooperativeKernel,
// the grid what the occupancy query says is co-resident) runs the 4k phases
// dwln, pw1, grn_stats and pw2 of each block in turn, with a grid barrier
// between phases where K2 has a launch boundary. Each phase walks its own
// items, K2's blocks in K2's launch order, with a loop over blockIdx.x:
// dwln (frame, image row), pw1 and pw2 (N tile, frame's M tile), grn_stats
// one frame. The tile shapes per stage are K2's (the host picks the
// instance by pw2_shape), so K3 is bit for bit k K2 launches with bf16
// rounding between blocks. The intermediates are plain (B, H, W, C) bf16
// ping-pong buffers (dwln reads them with a zero halo): block j's pw2 writes
// the buffer block j+1's dwln reads after a barrier, never the one it reads
// its residual from.
// Bound as for K2 (convnext_dwln.cuh, convnext_pw.cuh): grouping saves k-1
// launches and a read of x and a write of the output per block, not the
// hidden's round trip through device memory. Registers are capped at 128
// (__launch_bounds__(NT, 2)) so that two blocks share an SM, as the GEMM
// phases' shared memory (up to 110,592 bytes) allows; the dwln phase then
// runs with half the warps K2's own dwln launch has. Later speed work: a
// thread-block cluster could keep a stage-2/3 frame's hidden activation in
// distributed shared memory, so that it never reaches device memory, and a
// frame-local pw1 -> pw2 ownership would drop the grn_stats barriers.

#pragma once

#include <cooperative_groups.h>

#include "convnext_dwln.cuh"
#include "convnext_pw.cuh"

namespace {

using namespace cnx;
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

// x, out (B, H, W, C) in T; pp0, pp1 (B, H, W, C) bf16, the intermediates
// (pp1 used for k >= 3); a (B*HW, C), hid (B*HW, 4C) bf16, part (B, T1, 4C)
// and gn (B, 4C) f32: K2's buffers, written and read inside the launch
// (so never through the read-only path: no __restrict__ on them).
template <class S1, class S2, typename T>
__global__ void __launch_bounds__(NT, 2)
cnx_group(const T* __restrict__ x, T* __restrict__ out, bf16* pp0, bf16* pp1, bf16* a,
          bf16* hid, float* part, float* gn, Group g, int k, int B, int H, int W, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int HW = H * W, N = 4 * C;
  const int T1 = (HW + S1::BM - 1) / S1::BM, T2 = (HW + S2::BM - 1) / S2::BM;
  const int n1 = (N + S1::BN - 1) / S1::BN, n2 = (C + S2::BN - 1) / S2::BN;
  for (int j = 0; j < k; ++j) {
    const BlockW& w = g.b[j];
    const bf16* src = (j & 1) ? pp0 : pp1;  // block j-1's output (j >= 1)
    bf16* dst = (j & 1) ? pp1 : pp0;        // block j's, unless it is the last
    const bool last = j == k - 1;
    for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
      __syncthreads();  // the previous item is done with shared memory
      const int f = it / H, y = it - f * H;
      if constexpr (sizeof(T) == 2) {
        dwln_row<bf16>((float*)smem, j == 0 ? x : src, w.dw, w.dwb, w.lnw, w.lnb, a, H, W, C,
                       f, y);
      } else if (j == 0) {
        dwln_row<T>((float*)smem, x, w.dw, w.dwb, w.lnw, w.lnb, a, H, W, C, f, y);
      } else {
        dwln_row<bf16>((float*)smem, src, w.dw, w.dwb, w.lnw, w.lnb, a, H, W, C, f, y);
      }
    }
    grid.sync();
    for (int it = blockIdx.x; it < n1 * B * T1; it += gridDim.x) {
      __syncthreads();
      pw1_tile<S1>(smem, a, w.w1, w.b1, hid, part, HW, C, T1, it % n1, it / n1);
    }
    grid.sync();
    for (int f = blockIdx.x; f < B; f += gridDim.x) {
      __syncthreads();
      grn_frame(part, w.gamma, gn, T1, N, f);
    }
    grid.sync();
    const T* res = j == 0 ? x : (const T*)src;
    T* o = last ? out : (T*)dst;
    for (int it = blockIdx.x; it < n2 * B * T2; it += gridDim.x) {
      __syncthreads();
      pw2_tile<S2, T>(smem, hid, gn, w.beta, w.w2, w.b2, res, o, HW, C, T2, it % n2, it / n2, 0,
                      j > 0, !last);
    }
    if (!last) grid.sync();
  }
}

// the instance's dynamic shared memory: the largest phase's
template <class S1, class S2>
size_t group_smem(int W, int C) {
  size_t s = sizeof(float) * (size_t)W * C;  // dwln's row
  if (S1::SMEM > s) s = S1::SMEM;
  if (pw2_smem<S2>(C) > s) s = pw2_smem<S2>(C);
  return s;
}

// The grid: what is co-resident (blocks an SM by the occupancy query on the
// instance's shared memory and __launch_bounds__, times the SMs), at most
// the largest phase's items. info, if given: {blocks an SM, grid, shared
// memory bytes}.
template <class S1, class S2, typename T>
cudaError_t group_grid(int B, int H, int W, int C, int* grid, size_t* smem, int* info) {
  auto kern = cnx_group<S1, S2, T>;
  *smem = group_smem<S1, S2>(W, C);
  cudaError_t e = set_smem(kern, *smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, *smem);
  if (e != cudaSuccess) return e;
  const int HW = H * W;
  const int items1 = (4 * C + S1::BN - 1) / S1::BN * B * ((HW + S1::BM - 1) / S1::BM);
  const int items2 = (C + S2::BN - 1) / S2::BN * B * ((HW + S2::BM - 1) / S2::BM);
  int most = B * H > items1 ? B * H : items1;
  if (items2 > most) most = items2;
  *grid = per_sm * sms < most ? per_sm * sms : most;
  if (info) {
    info[0] = per_sm;
    info[1] = *grid;
    info[2] = (int)*smem;
  }
  return *grid < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <class S1, class S2, typename T>
int launch_group(const void* x, void* out, void* pp0, void* pp1, void* a, void* hid, void* part,
                 void* gn, const Group& grp, int k, int B, int H, int W, int C, int* info,
                 void* stream) {
  int grid = 0;
  size_t smem = 0;
  cudaError_t e = group_grid<S1, S2, T>(B, H, W, C, &grid, &smem, info);
  if (e != cudaSuccess || !x) return (int)e;  // no x: the occupancy query alone
  const T* xp = (const T*)x;
  T* op = (T*)out;
  bf16 *p0 = (bf16*)pp0, *p1 = (bf16*)pp1, *ap = (bf16*)a, *hp = (bf16*)hid;
  float *pt = (float*)part, *gp = (float*)gn;
  Group g = grp;
  void* args[] = {(void*)&xp, (void*)&op, (void*)&p0, (void*)&p1, (void*)&ap, (void*)&hp,
                  (void*)&pt, (void*)&gp, (void*)&g,  (void*)&k,  (void*)&B,  (void*)&H,
                  (void*)&W,  (void*)&C};
  e = cudaLaunchCooperativeKernel((const void*)cnx_group<S1, S2, T>, grid, NT, args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// BM: pw1's M tile, as K2's wrapper picks it; the pw2 shape follows K2's rule
template <typename T>
int group_entry(const void* x, void* out, void* pp0, void* pp1, void* a, void* hid, void* part,
                void* gn, const void* const* wptrs, int k, int B, int H, int W, int C, int BM,
                int* info, void* stream) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  Group g = {};
  for (int j = 0; j < k && wptrs; ++j) {
    const void* const* q = wptrs + 10 * j;
    g.b[j] = BlockW{(const float*)q[0], (const float*)q[1], (const float*)q[2],
                    (const float*)q[3], (const bf16*)q[4],  (const float*)q[5],
                    (const float*)q[6], (const float*)q[7], (const bf16*)q[8],
                    (const float*)q[9]};
  }
#define VS_GROUP(S1, S2) \
  launch_group<S1, S2, T>(x, out, pp0, pp1, a, hid, part, gn, g, k, B, H, W, C, info, stream)
  switch (pw2_shape(BM, C)) {
    case kPw2M64: return VS_GROUP(Pw1M64, Pw2M64);
    case kPw2M128: return VS_GROUP(Pw1M128, Pw2M128);
    case kPw2N192: return VS_GROUP(Pw1M128, Pw2N192);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VS_GROUP
}

}  // namespace

// vs_cnx_group_*: k blocks on x into out (see cnx_group for the buffers).
// vs_cnx_group_info_*: the occupancy query of the instance those shapes
// launch, {blocks an SM, grid, shared memory bytes} into info; nothing runs.
#define VS_ENTRY_GROUP(NAME, T)                                                                 \
  extern "C" int NAME(const void* x, void* out, void* pp0, void* pp1, void* a, void* hid,       \
                      void* part, void* gn, const void* wptrs, int k, int B, int H, int W,      \
                      int C, int BM, void* stream) {                                            \
    return group_entry<T>(x, out, pp0, pp1, a, hid, part, gn, (const void* const*)wptrs, k, B, \
                          H, W, C, BM, nullptr, stream);                                        \
  }                                                                                             \
  extern "C" int NAME##_info(int B, int H, int W, int C, int BM, int* info) {                   \
    return group_entry<T>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,        \
                          nullptr, nullptr, 1, B, H, W, C, BM, info, nullptr);                  \
  }
