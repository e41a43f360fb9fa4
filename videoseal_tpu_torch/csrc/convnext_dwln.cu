// K2, part 1 of 4 (dwln): the ConvNeXtV2 block's depthwise 7x7 conv, its
// bias and the channel LayerNorm, NHWC, one block per (image row, frame),
// at any H and W and at a width padded to a multiple of 16 (the pads zero).
// The body, its design and its bound are convnext_dwln.cuh's dwln_row, which
// K3 and the K8 probe share. The block's other parts are in convnext_pw.cu.

#include "convnext_dwln.cuh"

namespace {

using namespace cnx;

template <typename T>
__global__ void __launch_bounds__(NT)
cnx_dwln(const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ dwb,
         const float* __restrict__ lnw, const float* __restrict__ lnb, bf16* __restrict__ a,
         int H, int W, int C) {
  extern __shared__ __align__(16) float acc[];  // (W, C) f32 dw output + bias
  dwln_row<T>(acc, x, dw, dwb, lnw, lnb, a, H, W, C, blockIdx.y, blockIdx.x);
}

// the same on a width C padded past the true width Ct (a width that is not
// a multiple of 16): the LN over the Ct true channels. A kernel of its own,
// so that the aligned instance above compiles as it did
template <typename T>
__global__ void __launch_bounds__(NT)
cnx_dwln_tc(const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ dwb,
            const float* __restrict__ lnw, const float* __restrict__ lnb, bf16* __restrict__ a,
            int H, int W, int C, int Ct) {
  extern __shared__ __align__(16) float acc[];
  dwln_row<T, kDwPerDy, false, false, true>(acc, x, dw, dwb, lnw, lnb, a, H, W, C, blockIdx.y,
                                            blockIdx.x, Ct);
}

// Ct: the true width, C itself or less where C is padded
template <typename T>
int launch_dwln(const void* x, const void* dw, const void* dwb, const void* lnw, const void* lnb,
                void* a, int B, int H, int W, int C, int Ct, void* stream) {
  if (C % 16 || Ct < 1 || Ct > C) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)W * C;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  auto kern = cnx_dwln<T>;
  auto kern_tc = cnx_dwln_tc<T>;
  cudaError_t e = Ct == C ? cudaFuncSetAttribute(kern, attr, (int)smem)
                          : cudaFuncSetAttribute(kern_tc, attr, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B);
  if (Ct == C)
    kern<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const float*)dw, (const float*)dwb, (const float*)lnw, (const float*)lnb,
        (bf16*)a, H, W, C);
  else
    kern_tc<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const float*)dw, (const float*)dwb, (const float*)lnw, (const float*)lnb,
        (bf16*)a, H, W, C, Ct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vs_cnx_dwln_f32(const void* x, const void* dw, const void* dwb, const void* lnw,
                               const void* lnb, void* a, int B, int H, int W, int C, int Ct,
                               void* stream) {
  return launch_dwln<float>(x, dw, dwb, lnw, lnb, a, B, H, W, C, Ct, stream);
}

extern "C" int vs_cnx_dwln_bf16(const void* x, const void* dw, const void* dwb, const void* lnw,
                                const void* lnb, void* a, int B, int H, int W, int C, int Ct,
                                void* stream) {
  return launch_dwln<__nv_bfloat16>(x, dw, dwb, lnw, lnb, a, B, H, W, C, Ct, stream);
}
