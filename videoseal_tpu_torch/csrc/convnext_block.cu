// K2: one ConvNeXtV2 block, NHWC.
//
// K2 replaces videoseal_tpu/kernels/convnext_block.py::convnext_block_fused
// (Pallas body _block_math). Its parts (a) and (b), and why a block is split
// there, are in convnext_block.cuh; K2 launches each part as a kernel of its
// own over a (tile, frame) grid.
//
// Bound on the H100: at the extractor's shapes (B=32; 64x64x96 down to
// 8x8x768) the two pointwise products are ~90% of the block's FLOPs, ~1.2
// GFLOP per block at stage 0; in bytes the block reads x and writes the
// bf16 4C-wide hidden activation once and reads it back once (~100 MB at
// stage 0). With simple wmma tiles streaming the weights from L2, the
// products and the hidden round trip bound it.

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
