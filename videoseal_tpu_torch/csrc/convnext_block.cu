// The earlier K2 design: one ConvNeXtV2 block, NHWC, as two launches over a
// (tile, frame) grid, parts (a) and (b) of convnext_block.cuh, whose device
// functions K3 (convnext_group.cuh) and the K8 probe run. K2 itself is now
// convnext_dwln.cu and convnext_pw.cu; these entries serve
// kernels/convnext_block.py::_launch_split, which chip_smoke.py holds K3
// against bit for bit and times beside the new K2.
//
// It replaced videoseal_tpu/kernels/convnext_block.py::convnext_block_fused
// (Pallas body _block_math). Bound on the H100: at the extractor's shapes
// (B=32; 64x64x96 down to 8x8x768) the two pointwise products are ~90% of
// the block's FLOPs, ~1.2 GFLOP per block at stage 0; in bytes the block
// reads x and writes the bf16 4C-wide hidden activation once and reads it
// back once (~100 MB at stage 0). With simple wmma tiles streaming the
// weights from L2, the products and the hidden round trip bound it.

#include "convnext_block.cuh"

#define VS_ENTRY_A(NAME, T)                                                                \
  extern "C" int NAME(const void* xpad, const void* dw, const void* dwb, const void* lnw, \
                      const void* lnb, const void* w1, const void* b1, void* hmid,         \
                      void* part, int B, int H, int W, int C, int P, void* stream) {       \
    return launch_a<T>(xpad, dw, dwb, lnw, lnb, w1, b1, hmid, part, B, H, W, C, P, stream); \
  }
#define VS_ENTRY_B(NAME, T)                                                                 \
  extern "C" int NAME(const void* hmid, const void* part, const void* gamma,               \
                      const void* beta, const void* w2, const void* b2, const void* xpad,  \
                      void* out, int B, int H, int W, int C, int P, void* stream) {         \
    return launch_b<T>(hmid, part, gamma, beta, w2, b2, xpad, out, B, H, W, C, P, stream); \
  }

VS_ENTRY_A(vs_cnx_block_a_f32, float)
VS_ENTRY_A(vs_cnx_block_a_bf16, __nv_bfloat16)
VS_ENTRY_B(vs_cnx_block_b_f32, float)
VS_ENTRY_B(vs_cnx_block_b_bf16, __nv_bfloat16)
