// K8: the attribution probe of K2, K2's four parts (convnext_dwln.cuh,
// convnext_pw.cuh) with their switches set per variant.
//
// Replaces videoseal_tpu/kernels/convnext_probe.py::run (body build). The
// input xpad (B, H+6, W+6, C) bf16 has a halo that is data, as on the TPU:
// dwln reads it as it is (PAD) and pw2 takes its residual from xpad's
// interior. The depthwise-only variants run dwln alone, writing the bf16
// depthwise sum without its bias; the full-block variants run dwln with the
// variant's depthwise form, pw1 with its activation, grn_stats and pw2, on
// K2's tile shapes. Variant 9 is K2's own block: on a zero halo it is K2 bit
// for bit.

#include "convnext_dwln.cuh"
#include "convnext_pw.cuh"

namespace {

using namespace cnx;

template <int DW, bool DWONLY>
__global__ void __launch_bounds__(NT)
probe_dwln(const bf16* __restrict__ xpad, const float* __restrict__ dw,
           const float* __restrict__ dwb, const float* __restrict__ lnw,
           const float* __restrict__ lnb, bf16* __restrict__ a, int H, int W, int C) {
  extern __shared__ __align__(16) float acc[];
  dwln_row<bf16, DW, true, DWONLY>(acc, xpad, dw, dwb, lnw, lnb, a, H, W, C, blockIdx.y,
                                   blockIdx.x);
}

template <class S, int ACT>
__global__ void __launch_bounds__(NT)
probe_pw1(const bf16* __restrict__ a, const bf16* __restrict__ w1, const float* __restrict__ b1,
          bf16* __restrict__ hid, float* __restrict__ part, int HW, int C, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  pw1_tile<S, ACT>(smem, a, w1, b1, hid, part, HW, C, T, blockIdx.x, blockIdx.y);
}

__global__ void __launch_bounds__(NT)
probe_grn(const float* __restrict__ part, const float* __restrict__ gamma,
          float* __restrict__ gn, int T, int N) {
  grn_frame(part, gamma, gn, T, N, blockIdx.x);
}

template <class S>
__global__ void __launch_bounds__(NT)
probe_pw2(const bf16* __restrict__ hid, const float* __restrict__ gn,
          const float* __restrict__ beta, const bf16* __restrict__ w2,
          const float* __restrict__ b2, const bf16* __restrict__ xpad, bf16* __restrict__ out,
          int HW, int W, int C, int NTile) {
  extern __shared__ __align__(128) unsigned char smem[];
  pw2_tile<S, bf16, true>(smem, hid, gn, beta, w2, b2, xpad, out, HW, C, NTile, blockIdx.x,
                          blockIdx.y, W);
}

struct Params {  // block_params' layout
  const float *dw, *dwb, *lnw, *lnb;
  const bf16* w1;
  const float *b1, *gamma, *beta;
  const bf16* w2;
  const float* b2;
};

template <int DW, bool DWONLY>
int launch_dwln(const bf16* xpad, const Params& p, bf16* a, int B, int H, int W, int C,
                cudaStream_t st) {
  const size_t smem = DWONLY ? 0 : sizeof(float) * (size_t)W * C;
  cudaError_t e = set_smem(probe_dwln<DW, DWONLY>, smem);
  if (e != cudaSuccess) return (int)e;
  probe_dwln<DW, DWONLY><<<dim3(H, B), NT, smem, st>>>(xpad, p.dw, p.dwb, p.lnw, p.lnb, a, H, W,
                                                       C);
  return (int)cudaGetLastError();
}

template <class S, int ACT>
int launch_pw1(const bf16* a, const Params& p, bf16* hid, float* part, int B, int HW, int C,
               cudaStream_t st) {
  const int T = (HW + S::BM - 1) / S::BM;
  cudaError_t e = set_smem(probe_pw1<S, ACT>, S::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((4 * C + S::BN - 1) / S::BN, B * T);
  probe_pw1<S, ACT><<<grid, NT, S::SMEM, st>>>(a, p.w1, p.b1, hid, part, HW, C, T);
  return (int)cudaGetLastError();
}

template <class S>
int launch_pw2(const bf16* hid, const float* gn, const Params& p, const bf16* xpad, bf16* out,
               int B, int HW, int W, int C, cudaStream_t st) {
  const int NTile = (HW + S::BM - 1) / S::BM;
  const size_t smem = pw2_smem<S>(C);
  cudaError_t e = set_smem(probe_pw2<S>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + S::BN - 1) / S::BN, B * NTile);
  probe_pw2<S><<<grid, NT, smem, st>>>(hid, gn, p.beta, p.w2, p.b2, xpad, out, HW, W, C, NTile);
  return (int)cudaGetLastError();
}

// the full block after dwln: pw1 with ACT, grn_stats, pw2, on K2's shapes
template <int ACT>
int launch_rest(const bf16* a, const Params& p, bf16* hid, float* part, float* gn,
                const bf16* xpad, bf16* out, int B, int H, int W, int C, int BM,
                cudaStream_t st) {
  const int HW = H * W, S2 = pw2_shape(BM, C);
  if (S2 == kPw2None) return (int)cudaErrorInvalidValue;
  int e = BM == 128 ? launch_pw1<Pw1M128, ACT>(a, p, hid, part, B, HW, C, st)
                    : launch_pw1<Pw1M64, ACT>(a, p, hid, part, B, HW, C, st);
  if (e) return e;
  probe_grn<<<B, NT, 0, st>>>(part, p.gamma, gn, (HW + BM - 1) / BM, 4 * C);
  if ((e = (int)cudaGetLastError())) return e;
  if (S2 == kPw2M64) return launch_pw2<Pw2M64>(hid, gn, p, xpad, out, B, HW, W, C, st);
  if (S2 == kPw2M128) return launch_pw2<Pw2M128>(hid, gn, p, xpad, out, B, HW, W, C, st);
  return launch_pw2<Pw2N192>(hid, gn, p, xpad, out, B, HW, W, C, st);
}

}  // namespace

// variant: its index in kernels/convnext_probe.py::VARIANTS. The
// depthwise-only variants (0-3) write out (B, H, W, C) bf16 and touch none
// of a, hid, part, gn. BM: pw1's M tile, as K2's wrapper picks it.
extern "C" int vs_cnx_probe(const void* xpad, const void* dw, const void* dwb, const void* lnw,
                            const void* lnb, const void* w1, const void* b1, const void* gamma,
                            const void* beta, const void* w2, const void* b2, void* a, void* hid,
                            void* part, void* gn, void* out, int B, int H, int W, int C, int BM,
                            int variant, void* stream) {
  if (C % 16) return (int)cudaErrorInvalidValue;
  const Params p{(const float*)dw, (const float*)dwb, (const float*)lnw, (const float*)lnb,
                 (const bf16*)w1,  (const float*)b1,  (const float*)gamma, (const float*)beta,
                 (const bf16*)w2,  (const float*)b2};
  const bf16* x = (const bf16*)xpad;
  bf16 *ap = (bf16*)a, *o = (bf16*)out, *hp = (bf16*)hid;
  float *pt = (float*)part, *gp = (float*)gn;
  cudaStream_t st = (cudaStream_t)stream;
  int e;
  switch (variant) {
    case 0: return launch_dwln<kDwTaps, true>(x, p, o, B, H, W, C, st);
    case 1: return launch_dwln<kDwShift, true>(x, p, o, B, H, W, C, st);
    case 2: return launch_dwln<kDwPerDy, true>(x, p, o, B, H, W, C, st);
    case 3: return launch_dwln<kDwBf16, true>(x, p, o, B, H, W, C, st);
    case 4:
    case 5:
    case 6:
    case 7: e = launch_dwln<kDwShift, false>(x, p, ap, B, H, W, C, st); break;
    case 8: e = launch_dwln<kDwBf16, false>(x, p, ap, B, H, W, C, st); break;
    case 9: e = launch_dwln<kDwPerDy, false>(x, p, ap, B, H, W, C, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
#define VS_REST(ACT) launch_rest<ACT>(ap, p, hp, pt, gp, x, o, B, H, W, C, BM, st)
  switch (variant) {
    case 4: return VS_REST(kActNone);
    case 6: return VS_REST(kActSigmoid);
    case 7:
    case 8: return VS_REST(kActTanh);
    default: return VS_REST(kActErf);  // 5 (block_gelu) and 9 (K2's own block)
  }
#undef VS_REST
}
