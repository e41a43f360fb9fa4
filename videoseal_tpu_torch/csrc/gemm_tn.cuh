// The tiled tensor-core GEMM core of K2's pointwise products (convnext_pw.cu).
//
// C (M x N, f32 sums) = A (M x K) * B^T, A and B bf16 and both K-contiguous
// ("TN": A row-major, B in torch Linear layout (N, K)). The M rows are cut
// into frames of HW rows, and an M tile never crosses a frame: the tile
// (frame f, tile t) holds rows f*HW + t*BM ... of which `rows` are valid;
// the rest, and columns at or past N, are zero-filled on load.
//
// Design for the H100's shared memory, tensor cores and asynchronous copies:
// 256 threads (8 warps, WM along M x 8/WM along N) own a BM x BN tile; K is
// walked in BK-wide slices held in a ring of STAGES in shared memory, filled
// by cp.async (16 bytes a thread, zero-filled at the edges) STAGES - 1 slices
// ahead of the product; rows are padded by 16 bytes, so that ldmatrix's
// eight row addresses fall in distinct bank groups. Each warp loads its
// fragments with ldmatrix and runs mma.sync.m16n8k16 (bf16 in, f32
// accumulation) on its (BM/WM) x (BN/(8/WM)) sub-tile. A prologue functor may
// rewrite the A slice in place before the product (pw2's GRN): it touches
// only the 16-byte chunks its own thread copied, after cp.async.wait_group,
// so the barrier that every slice needs anyway orders it before ldmatrix.
// After the loop the accumulators are staged through shared memory as an f32
// BM x BN tile (row stride BN + 8) for the caller's coalesced epilogue.
// The tile shapes are template parameters (Shape); each caller instantiates
// few.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace gemm {

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;  // threads per block: 8 warps

// A tile's shape: BM x BN outputs, K slices of BK in a ring of STAGES, the
// 8 warps WM along M by 8 / WM along N; rows of a staged slice padded by 8
// bf16 (16 bytes)
template <int BM_, int BN_, int BK_, int STAGES_, int WM_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_, WM = WM_, WN = 8 / WM_;
  static constexpr int LDS = BK + 8, CPR = BK / 8;  // padded row; 16-byte chunks a row
  static constexpr int MT = BM / WM / 16, NTL = BN / WN / 8;  // m16 and n8 tiles a warp
  static constexpr int CLD = BN + 8;                // row of the staged f32 tile
  static constexpr size_t RING = (size_t)STAGES * (BM + BN) * LDS * 2;
  static constexpr size_t SMEM = RING > (size_t)BM * CLD * 4 ? RING : (size_t)BM * CLD * 4;
  static_assert(WM * WN == 8 && MT >= 1 && NTL >= 1 && BM % (WM * 16) == 0 &&
                    BN % (WN * 8) == 0 && BK % 16 == 0,
                "tile shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-fills the destination when !ok (src must
// still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct NoPrologue {
  __device__ __forceinline__ void operator()(bf16*, int, int) const {}
};

// The loads of slice kt into one ring stage. The A loop is the one a
// prologue repeats: thread tid owns chunks i = tid, tid + NT, ... of the
// BM x CPR chunks, row i / CPR, chunk i % CPR.
template <class S>
__device__ __forceinline__ void load_slice(bf16* As, bf16* Bs, const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, int K, int N, int row0,
                                           int rows, int n0, int kt) {
  const int tid = threadIdx.x;
  for (int i = tid; i < S::BM * S::CPR; i += NT) {
    const int r = i / S::CPR, ch = i % S::CPR, k = kt * S::BK + ch * 8;
    const bool ok = r < rows && k < K;
    cp_async16(As + r * S::LDS + ch * 8, ok ? A + (size_t)(row0 + r) * K + k : A, ok);
  }
  for (int i = tid; i < S::BN * S::CPR; i += NT) {
    const int n = i / S::CPR, ch = i % S::CPR, k = kt * S::BK + ch * 8;
    const bool ok = n0 + n < N && k < K;
    cp_async16(Bs + n * S::LDS + ch * 8, ok ? B + (size_t)(n0 + n) * K + k : B, ok);
  }
}

// The product of one tile into acc; then acc staged as the f32 tile Cs
// (BM x CLD) at the start of smem, which the function returns after a
// barrier. pro(As, kt, rows) runs on each slice of A before its product.
template <class S, class Pro>
__device__ __forceinline__ float* gemm_tn(unsigned char* smem, const bf16* __restrict__ A,
                                          const bf16* __restrict__ B, int K, int N, int row0,
                                          int rows, int n0, const Pro& pro) {
  constexpr int MT = S::MT, NTL = S::NTL, LDS = S::LDS, STAGES = S::STAGES, BK = S::BK;
  constexpr int STEP = (S::BM + S::BN) * LDS;  // one ring stage, bf16
  bf16* ring = (bf16*)smem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm0 = (warp % S::WM) * (S::BM / S::WM), wn0 = (warp / S::WM) * (S::BN / S::WN);
  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_slice<S>(ring + s * STEP, ring + s * STEP + S::BM * LDS, A, B, K, N, row0,
                              rows, n0, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();  // this thread's copies of slice kt have landed
    bf16* As = ring + (kt % STAGES) * STEP;
    const bf16* Bs = As + S::BM * LDS;
    pro(As, kt, rows);
    // every thread's slice kt is in place (and rewritten), and every thread
    // is done with slice kt - 1, whose stage the next load refills
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      bf16* An = ring + (nk % STAGES) * STEP;
      load_slice<S>(An, An + S::BM * LDS, A, B, K, N, row0, rows, n0, nk);
    }
    cp_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NTL][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], As + (wm0 + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NTL; ++j)
        ldmatrix_x2(bfr[j], Bs + (wn0 + j * 8 + (lane & 7)) * LDS + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: stage the accumulators over it
  float* Cs = (float*)smem;
  constexpr int CLD = S::CLD;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const int r = wm0 + i * 16 + g, c = wn0 + j * 8 + 2 * t4;
      *(float2*)(Cs + r * CLD + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *(float2*)(Cs + (r + 8) * CLD + c) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  return Cs;
}

}  // namespace gemm
