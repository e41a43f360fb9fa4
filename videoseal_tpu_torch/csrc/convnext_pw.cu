// K2, parts 2-4 of 4: pw1 (+ GELU and GRN's partial sums), grn_stats and
// pw2 (GRN applied to the hidden, + bias + residual), four launches with
// dwln (convnext_dwln.cu) on one stream. The bodies, their design and bound
// are convnext_pw.cuh's pw1_tile, grn_frame and pw2_tile, on the GEMM core of
// gemm_tn.cuh, which K3 and the K8 probe share.

#include "convnext_pw.cuh"

namespace {

using namespace cnx;

// grid (ceil(4C / BN), B * T); T = ceil(HW / BM) M tiles per frame
template <class S>
__global__ void __launch_bounds__(NT)
cnx_pw1(const bf16* __restrict__ a, const bf16* __restrict__ w1, const float* __restrict__ b1,
        bf16* __restrict__ hid, float* __restrict__ part, int HW, int C, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  pw1_tile<S>(smem, a, w1, b1, hid, part, HW, C, T, blockIdx.x, blockIdx.y);
}

// one block per frame: part (B, T, N) -> gn (B, N)
__global__ void __launch_bounds__(NT)
cnx_grn(const float* __restrict__ part, const float* __restrict__ gamma, float* __restrict__ gn,
        int T, int N) {
  grn_frame(part, gamma, gn, T, N, blockIdx.x);
}

// the same on a width N padded past the true width Nt: GRN's channel mean
// over the Nt true columns; a kernel of its own, so that the aligned one
// above compiles as it did
__global__ void __launch_bounds__(NT)
cnx_grn_tn(const float* __restrict__ part, const float* __restrict__ gamma,
           float* __restrict__ gn, int T, int N, int Nt) {
  grn_frame<true>(part, gamma, gn, T, N, blockIdx.x, Nt);
}

// grid (ceil(C / BN), B * T)
template <class S, typename T>
__global__ void __launch_bounds__(NT)
cnx_pw2(const bf16* __restrict__ hid, const float* __restrict__ gn,
        const float* __restrict__ beta, const bf16* __restrict__ w2,
        const float* __restrict__ b2, const T* __restrict__ x, T* __restrict__ out, int HW, int C,
        int NTile) {
  extern __shared__ __align__(128) unsigned char smem[];
  pw2_tile<S, T>(smem, hid, gn, beta, w2, b2, x, out, HW, C, NTile, blockIdx.x, blockIdx.y);
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
  const size_t smem = pw2_smem<S>(C);
  cudaError_t e = set_smem(cnx_pw2<S, T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + S::BN - 1) / S::BN, B * NTile);
  cnx_pw2<S, T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)hid, (const float*)gn, (const float*)beta, (const bf16*)w2, (const float*)b2,
      (const T*)x, (T*)out, HW, C, NTile);
  return (int)cudaGetLastError();
}

// BM: pw1's M tile (pw2 takes its own from it and C)
template <typename T>
int pw2_entry(const void* hid, const void* gn, const void* beta, const void* w2, const void* b2,
              const void* x, void* out, int B, int HW, int C, int BM, void* stream) {
  switch (pw2_shape(BM, C)) {
    case kPw2M64: return launch_pw2<Pw2M64, T>(hid, gn, beta, w2, b2, x, out, B, HW, C, stream);
    case kPw2M128: return launch_pw2<Pw2M128, T>(hid, gn, beta, w2, b2, x, out, B, HW, C, stream);
    case kPw2N192: return launch_pw2<Pw2N192, T>(hid, gn, beta, w2, b2, x, out, B, HW, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Nt: the true width, N itself or less where N is padded
extern "C" int vs_cnx_grn(const void* part, const void* gamma, void* gn, int B, int T, int N,
                          int Nt, void* stream) {
  if (Nt < 1 || Nt > N) return (int)cudaErrorInvalidValue;
  if (Nt == N)
    cnx_grn<<<B, NT, 0, (cudaStream_t)stream>>>((const float*)part, (const float*)gamma,
                                                (float*)gn, T, N);
  else
    cnx_grn_tn<<<B, NT, 0, (cudaStream_t)stream>>>((const float*)part, (const float*)gamma,
                                                   (float*)gn, T, N, Nt);
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
