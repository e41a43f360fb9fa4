// The ConvNeXtV2 block's parts 2-4 as device functions on the GEMM core of
// gemm_tn.cuh: pw1 (+ GELU and GRN's partial sums), grn_stats and pw2 (GRN
// applied to the hidden, + bias + residual). Part 1, dwln, is
// convnext_dwln.cuh. K2 (convnext_pw.cu) calls each once per block of its
// grid, K3 (convnext_group.cuh) once per item of its phases, the K8 probe
// (convnext_probe.cu) with its activation and its padded residual.
//
// K2 replaces videoseal_tpu/kernels/convnext_block.py::convnext_block_fused
// (Pallas body _block_math). The TPU kept a whole frame in VMEM; here GRN's
// reduction over a frame's pixels sits between the two products, so a block
// is four steps, ordered by launch boundaries (K2) or grid barriers (K3):
//   pw1:  A (B*HW, C) x W1^T, W1 (4C, C) -> + b1 -> erf GELU -> bf16 hidden
//         (B*HW, 4C), and per (frame, M tile) and column the sum of squares
//         of the bf16 hidden (f32 in a fixed order: deterministic, no atomics;
//         each entry has one writer, the tile's N-tile item);
//   grn_stats: one item per frame sums its partials in tile order ->
//         gx = sqrt(max(s, 1e-12)), gn = gamma * gx / (mean_c gx + 1e-6);
//   pw2:  each staged hidden K slice is rewritten in place to
//         bf16(gn * h + beta + h) (the frame's gn and beta staged in shared
//         memory once), then x W2^T, W2 (C, 4C) -> + b2 + x, in x's dtype.
// The rounding points are the plain version's (kernels/convnext_block.py:
// pw1_plain, grn_stats_plain, pw2_plain).
//
// Bound on the H100: at the extractor's shapes each product is 9.66 GFLOP
// per 32-frame chunk (tensor cores, ~10 us at the bf16 peak) while the
// bf16 hidden is written once and read once (100 MB each way at stage 0,
// ~30 us each): bytes bound both GEMMs. So M tiles are frame-local and the
// N dimension is tiled too (stage 3, 64 pixels a frame, still gets 768 pw1
// tiles), the weights come through the cp.async ring from L2, and the
// epilogues write 16-byte rows of the f32 tile staged in shared memory.

#pragma once

#include "gemm_tn.cuh"

namespace cnx {

using gemm::bf16;
using gemm::NT;

// the activation after pw1: the model's erf GELU, and the K8 probe's others
enum Act { kActErf = 0, kActNone = 1, kActTanh = 2, kActSigmoid = 3 };

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if constexpr (ACT == kActErf) return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  else if constexpr (ACT == kActTanh)
    return 0.5f * v * (1.f + tanhf(0.7978845608f * (v + 0.044715f * v * v * v)));
  else if constexpr (ACT == kActSigmoid) return v / (1.f + expf(-1.702f * v));
  else return v;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *(const float4*)p, b = *(const float4*)(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
  const __nv_bfloat162* h = (const __nv_bfloat162*)&u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  unpack8(*(const uint4*)p, v);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
  *(float4*)(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = (__nv_bfloat162*)&u;
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return u;
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) { *(uint4*)p = pack8(v); }

// pw1's output tile (N tile nt, M tile ft = f * T + t): T = ceil(HW / BM)
// M tiles per frame. nt and ft are unsigned, as blockIdx is: K2's index
// arithmetic, and so its machine code, stays as it was written on blockIdx.
template <class S, int ACT = kActErf>
__device__ __forceinline__ void pw1_tile(unsigned char* smem, const bf16* __restrict__ a,
                                         const bf16* __restrict__ w1,
                                         const float* __restrict__ b1, bf16* __restrict__ hid,
                                         float* __restrict__ part, int HW, int C, int T,
                                         unsigned nt, unsigned ft) {
  const int N = 4 * C, n0 = nt * S::BN;
  const int f = ft / T, t = ft - f * T;
  const int row0 = f * HW + t * S::BM, rows = min(S::BM, HW - t * S::BM);
  float* Cs = gemm::gemm_tn<S>(smem, a, w1, C, N, row0, rows, n0, gemm::NoPrologue());
  constexpr int CLD = S::CLD, G = S::BN / 8, RL = NT / G;
  static_assert(NT % G == 0 && RL <= S::BM, "a thread keeps one 8-column group");
  // + b1, the activation, bf16: 8 columns a thread, one 16-byte store. A
  // thread keeps one column group for rows tid / G, tid / G + RL, ... and
  // sums the rounded values' squares in that row order
  const int c = (threadIdx.x % G) * 8, n = n0 + c;
  float sq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sq[j] = 0.f;
  if (n < N) {
    float b[8];
    load8(b1 + n, b);
    for (int r = threadIdx.x / G; r < rows; r += RL) {
      float v[8];
      load8(Cs + r * CLD + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = act<ACT>(v[j] + b[j]);
      const uint4 u = pack8(v);
      *(uint4*)(hid + (size_t)(row0 + r) * N + n) = u;
      unpack8(u, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) sq[j] += v[j] * v[j];
    }
  }
  __syncthreads();  // Cs is read: its first RL rows take the RL partial rows
  store8(Cs + (threadIdx.x / G) * CLD + c, sq);
  __syncthreads();
  for (int cc = threadIdx.x; cc < S::BN; cc += NT) {
    if (n0 + cc >= N) continue;
    float s = 0.f;
    for (int l = 0; l < RL; ++l) s += Cs[l * CLD + cc];
    part[((size_t)f * T + t) * N + n0 + cc] = s;
  }
}

// grn_stats of frame f: part (B, T, N) -> gn (B, N). TRUEN: N is a width
// padded with zero columns (zero gamma) past the true width Nt, and the mean
// of gx is taken over the Nt true columns; without it Nt is not read.
template <bool TRUEN = false>
__device__ __forceinline__ void grn_frame(const float* __restrict__ part,
                                          const float* __restrict__ gamma,
                                          float* __restrict__ gn, int T, int N, int f,
                                          int Nt = 0) {
  __shared__ float red[NT / 32];
  const int tid = threadIdx.x;
  const float* pf = part + (size_t)f * T * N;
  float* g = gn + (size_t)f * N;
  float local = 0.f;
  for (int ch = tid; ch < N; ch += NT) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += pf[(size_t)t * N + ch];
    const float gx = sqrtf(fmaxf(s, 1e-12f));
    g[ch] = gx;
    if (!TRUEN || ch < Nt) local += gx;
  }
  for (int o = 16; o > 0; o >>= 1) local += __shfl_xor_sync(0xffffffffu, local, o);
  if ((tid & 31) == 0) red[tid >> 5] = local;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < NT / 32; ++w) total += red[w];
  const float denom = total / (TRUEN ? Nt : N) + 1e-6f;
  for (int ch = tid; ch < N; ch += NT) g[ch] = gamma[ch] * (g[ch] / denom);
}

// pw2's prologue: GRN on this thread's own chunks of the staged hidden slice
template <class S>
struct GrnPrologue {
  const float* gn;    // the frame's (4C), in shared memory
  const float* beta;  // (4C), in shared memory
  __device__ __forceinline__ void operator()(bf16* As, int kt, int rows) const {
    for (int i = threadIdx.x; i < S::BM * S::CPR; i += NT) {
      const int r = i / S::CPR, ch = i % S::CPR, k = kt * S::BK + ch * 8;
      if (r >= rows) continue;
      bf16* p = As + r * S::LDS + ch * 8;
      float h[8], gv[8], bv[8];
      load8(p, h);
      load8(gn + k, gv);
      load8(beta + k, bv);
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = __fadd_rn(__fadd_rn(__fmul_rn(gv[j], h[j]), bv[j]), h[j]);
      store8(p, h);
    }
  }
};

// pw2's shared memory: the ring (or the f32 tile) and the frame's gn and beta
template <class S>
inline size_t pw2_smem(int C) {
  return S::SMEM + sizeof(float) * 8 * C;
}

// pw2's output tile (N tile nt, M tile ft = f * NTile + t; unsigned, as for
// pw1_tile). The residual x
// and out are (B*HW, C) in T. PAD (the probe): x is (B, H+6, W+6, C) whose
// interior is the residual. K3's f32 instance runs its bf16 intermediates
// through T = float: x_bf16 / out_bf16 say that x / out hold bf16.
template <class S, typename T, bool PAD = false>
__device__ __forceinline__ void pw2_tile(unsigned char* smem, const bf16* __restrict__ hid,
                                         const float* __restrict__ gn,
                                         const float* __restrict__ beta,
                                         const bf16* __restrict__ w2,
                                         const float* __restrict__ b2, const T* __restrict__ x,
                                         T* __restrict__ out, int HW, int C, int NTile,
                                         unsigned nt, unsigned ft, int W = 0,
                                         bool x_bf16 = false, bool out_bf16 = false) {
  const int K = 4 * C, n0 = nt * S::BN;
  const int f = ft / NTile, t = ft - f * NTile;
  const int row0 = f * HW + t * S::BM, rows = min(S::BM, HW - t * S::BM);
  // the frame's gn and beta beside the ring, read by every slice's prologue
  float* sg = (float*)(smem + S::SMEM);
  for (int i = threadIdx.x; i < K; i += NT) {
    sg[i] = gn[(size_t)f * K + i];
    sg[K + i] = beta[i];
  }
  __syncthreads();
  const GrnPrologue<S> pro{sg, sg + K};
  const float* Cs = gemm::gemm_tn<S>(smem, hid, w2, K, C, row0, rows, n0, pro);
  constexpr int CLD = S::CLD, G = S::BN / 8;
  for (int i = threadIdx.x; i < S::BM * G; i += NT) {
    const int r = i / G, c = (i - r * G) * 8, n = n0 + c;
    if (r >= rows || n >= C) continue;
    const size_t o = (size_t)(row0 + r) * C + n;
    float v[8], b[8], res[8];
    load8(Cs + r * CLD + c, v);
    load8(b2 + n, b);
    if constexpr (PAD) {
      const int p = t * S::BM + r, y = p / W, xx = p - y * W;
      load8(x + (((size_t)f * (HW / W + 6) + y + 3) * (W + 6) + xx + 3) * C + n, res);
    } else if constexpr (sizeof(T) == 4) {
      if (x_bf16) load8((const bf16*)x + o, res);
      else load8(x + o, res);
    } else {
      load8(x + o, res);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] + b[j]) + res[j];
    if constexpr (sizeof(T) == 4) {
      if (out_bf16) store8((bf16*)out + o, v);
      else store8(out + o, v);
    } else {
      store8(out + o, v);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the shapes K2 runs, timed on the H100 against 256-wide and 4-stage tiles
// (larger tiles lost occupancy): pw1's M tile is 128 rows, or 64 where a
// frame is smaller, with K slices of 64. pw2's N tile, 96, divides every
// extractor width (96 to 768); where 192 divides C and frames hold 128
// pixels, 64 x 192 tiles were faster. Which pair a block runs: BM (pw1's
// M tile, picked by the wrapper) and C, the rule of pw2_shape.
typedef gemm::Shape<128, 128, 64, 3, 2> Pw1M128;
typedef gemm::Shape<64, 128, 64, 3, 2> Pw1M64;
typedef gemm::Shape<128, 96, 32, 3, 2> Pw2M128;
typedef gemm::Shape<64, 192, 32, 3, 2> Pw2N192;
typedef gemm::Shape<64, 96, 64, 3, 2> Pw2M64;

enum Pw2Shape { kPw2M64 = 0, kPw2M128 = 1, kPw2N192 = 2, kPw2None = -1 };

// pw2's tile shape for pw1's M tile BM and width C
inline int pw2_shape(int BM, int C) {
  if (C % 16) return kPw2None;
  if (BM == 64) return kPw2M64;
  if (BM != 128) return kPw2None;
  return C % 192 == 0 ? kPw2N192 : kPw2M128;
}

}  // namespace cnx
