// K2, parts 2-4 of 4: pw1 (+ GELU and GRN's partial sums), grn_stats and
// pw2 (GRN applied to the hidden, + bias + residual), on the GEMM core of
// gemm_tn.cuh. Part 1, dwln, is convnext_dwln.cu.
//
// K2 replaces videoseal_tpu/kernels/convnext_block.py::convnext_block_fused
// (Pallas body _block_math). The TPU kept a whole frame in VMEM; here GRN's
// reduction over a frame's pixels sits between the two products, so a block
// is four launches on one stream, whose boundaries order it:
//   pw1:  A (B*HW, C) x W1^T, W1 (4C, C) -> + b1 -> erf GELU -> bf16 hidden
//         (B*HW, 4C), and per (frame, M tile) and column the sum of squares
//         of the bf16 hidden (f32 in a fixed order: deterministic, no atomics;
//         each entry has one writer, the tile's N-tile block);
//   grn_stats: one block per frame sums its partials in tile order ->
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
// grid also tiles N (stage 3, 64 pixels a frame, still gets 768 pw1
// blocks), the weights come through the cp.async ring from L2, and the
// epilogues write 16-byte rows of the f32 tile staged in shared memory.

#include "gemm_tn.cuh"

namespace {

using gemm::bf16;
using gemm::NT;

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
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

// grid (ceil(4C / BN), B * T); T = ceil(HW / BM) M tiles per frame
template <class S>
__global__ void __launch_bounds__(NT)
cnx_pw1(const bf16* __restrict__ a, const bf16* __restrict__ w1, const float* __restrict__ b1,
        bf16* __restrict__ hid, float* __restrict__ part, int HW, int C, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = 4 * C, n0 = blockIdx.x * S::BN;
  const int f = blockIdx.y / T, t = blockIdx.y - f * T;
  const int row0 = f * HW + t * S::BM, rows = min(S::BM, HW - t * S::BM);
  float* Cs = gemm::gemm_tn<S>(smem, a, w1, C, N, row0, rows, n0, gemm::NoPrologue());
  constexpr int CLD = S::CLD, G = S::BN / 8, RL = NT / G;
  static_assert(NT % G == 0 && RL <= S::BM, "a thread keeps one 8-column group");
  // + b1, GELU, bf16: 8 columns a thread, one 16-byte store. A thread keeps
  // one column group for rows tid / G, tid / G + RL, ... and sums the
  // rounded values' squares in that row order
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
      for (int j = 0; j < 8; ++j) v[j] = gelu(v[j] + b[j]);
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

// one block per frame: part (B, T, N) -> gn (B, N)
__global__ void __launch_bounds__(NT)
cnx_grn(const float* __restrict__ part, const float* __restrict__ gamma, float* __restrict__ gn,
        int T, int N) {
  __shared__ float red[NT / 32];
  const int f = blockIdx.x, tid = threadIdx.x;
  const float* pf = part + (size_t)f * T * N;
  float* g = gn + (size_t)f * N;
  float local = 0.f;
  for (int ch = tid; ch < N; ch += NT) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += pf[(size_t)t * N + ch];
    const float gx = sqrtf(fmaxf(s, 1e-12f));
    g[ch] = gx;
    local += gx;
  }
  for (int o = 16; o > 0; o >>= 1) local += __shfl_xor_sync(0xffffffffu, local, o);
  if ((tid & 31) == 0) red[tid >> 5] = local;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < NT / 32; ++w) total += red[w];
  const float denom = total / N + 1e-6f;
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

// grid (ceil(C / BN), B * T)
template <class S, typename T>
__global__ void __launch_bounds__(NT)
cnx_pw2(const bf16* __restrict__ hid, const float* __restrict__ gn,
        const float* __restrict__ beta, const bf16* __restrict__ w2,
        const float* __restrict__ b2, const T* __restrict__ x, T* __restrict__ out, int HW, int C,
        int NTile) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = 4 * C, n0 = blockIdx.x * S::BN;
  const int f = blockIdx.y / NTile, t = blockIdx.y - f * NTile;
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
    load8(x + o, res);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] + b[j]) + res[j];
    store8(out + o, v);
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class S>
int launch_pw1(const void* a, const void* w1, const void* b1, void* hid, void* part, int B,
               int HW, int C, void* stream) {
  const int T = (HW + S::BM - 1) / S::BM;
  cudaError_t e = set_smem(cnx_pw1<S>, S::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((4 * C + S::BN - 1) / S::BN, B * T);
  cnx_pw1<S><<<grid, NT, S::SMEM, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)w1, (const float*)b1, (bf16*)hid, (float*)part, HW, C, T);
  return (int)cudaGetLastError();
}

template <class S, typename T>
int launch_pw2(const void* hid, const void* gn, const void* beta, const void* w2, const void* b2,
               const void* x, void* out, int B, int HW, int C, void* stream) {
  const int NTile = (HW + S::BM - 1) / S::BM;
  const size_t smem = S::SMEM + sizeof(float) * 8 * C;  // + gn and beta
  cudaError_t e = set_smem(cnx_pw2<S, T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + S::BN - 1) / S::BN, B * NTile);
  cnx_pw2<S, T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)hid, (const float*)gn, (const float*)beta, (const bf16*)w2, (const float*)b2,
      (const T*)x, (T*)out, HW, C, NTile);
  return (int)cudaGetLastError();
}

// the shapes K2 runs, timed on the H100 against 256-wide and 4-stage tiles
// (larger tiles lost occupancy): pw1's M tile is 128 rows, or 64 where a
// frame is smaller, with K slices of 64. pw2's N tile, 96, divides every
// extractor width (96 to 768); where 192 divides C and frames hold 128
// pixels, 64 x 192 tiles were faster.
typedef gemm::Shape<128, 128, 64, 3, 2> Pw1M128;
typedef gemm::Shape<64, 128, 64, 3, 2> Pw1M64;
typedef gemm::Shape<128, 96, 32, 3, 2> Pw2M128;
typedef gemm::Shape<64, 192, 32, 3, 2> Pw2N192;
typedef gemm::Shape<64, 96, 64, 3, 2> Pw2M64;

// BM: pw1's M tile (pw2 takes its own from it and C)
template <typename T>
int pw2_entry(const void* hid, const void* gn, const void* beta, const void* w2, const void* b2,
              const void* x, void* out, int B, int HW, int C, int BM, void* stream) {
  if (C % 16) return (int)cudaErrorInvalidValue;
  if (BM == 64) return launch_pw2<Pw2M64, T>(hid, gn, beta, w2, b2, x, out, B, HW, C, stream);
  if (BM != 128) return (int)cudaErrorInvalidValue;
  if (C % 192 == 0)
    return launch_pw2<Pw2N192, T>(hid, gn, beta, w2, b2, x, out, B, HW, C, stream);
  return launch_pw2<Pw2M128, T>(hid, gn, beta, w2, b2, x, out, B, HW, C, stream);
}

}  // namespace

// BM: the M tile, 128 or 64 rows (frame-local)
extern "C" int vs_cnx_pw1(const void* a, const void* w1, const void* b1, void* hid, void* part,
                          int B, int HW, int C, int BM, void* stream) {
  if (C % 16) return (int)cudaErrorInvalidValue;
  if (BM == 128) return launch_pw1<Pw1M128>(a, w1, b1, hid, part, B, HW, C, stream);
  if (BM == 64) return launch_pw1<Pw1M64>(a, w1, b1, hid, part, B, HW, C, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int vs_cnx_grn(const void* part, const void* gamma, void* gn, int B, int T, int N,
                          void* stream) {
  cnx_grn<<<B, NT, 0, (cudaStream_t)stream>>>((const float*)part, (const float*)gamma,
                                              (float*)gn, T, N);
  return (int)cudaGetLastError();
}

extern "C" int vs_cnx_pw2_f32(const void* hid, const void* gn, const void* beta, const void* w2,
                              const void* b2, const void* x, void* out, int B, int HW, int C,
                              int BM, void* stream) {
  return pw2_entry<float>(hid, gn, beta, w2, b2, x, out, B, HW, C, BM, stream);
}

extern "C" int vs_cnx_pw2_bf16(const void* hid, const void* gn, const void* beta, const void* w2,
                               const void* b2, const void* x, void* out, int B, int HW, int C,
                               int BM, void* stream) {
  return pw2_entry<__nv_bfloat16>(hid, gn, beta, w2, b2, x, out, B, HW, C, BM, stream);
}
