// K8: the attribution probe of K2, the instances of K2's part (a) template
// (convnext_block.cuh) with its parts switched.
//
// Replaces videoseal_tpu/kernels/convnext_probe.py::run (body build): the
// depthwise-only variants write the bf16 dw output and stop; the full-block
// variants run part (a) with the variant's depthwise form and activation,
// then K2's part (b) unchanged. Variant 9 is K2's own part (a).

#include "convnext_block.cuh"

// variant: its index in kernels/convnext_probe.py::VARIANTS. xpad (B, H+6,
// W+6, C) bf16 whose halo is data, as on the TPU. The depthwise-only
// variants write out (B, H, W, C) bf16 and do not touch hmid or part.
extern "C" int vs_cnx_probe(const void* xpad, const void* dw, const void* dwb, const void* lnw,
                            const void* lnb, const void* w1, const void* b1, const void* gamma,
                            const void* beta, const void* w2, const void* b2, void* hmid,
                            void* part, void* out, int B, int H, int W, int C, int P,
                            int variant, void* stream) {
  typedef __nv_bfloat16 T;
#define VS_A(DW, ACT, ONLY, DST) \
  launch_a<T, DW, ACT, ONLY>(xpad, dw, dwb, lnw, lnb, w1, b1, DST, part, B, H, W, C, P, stream)
  int e;
  switch (variant) {
    case 0: return VS_A(kDwTaps, kActNone, true, out);
    case 1: return VS_A(kDwShift, kActNone, true, out);
    case 2: return VS_A(kDwPerDy, kActNone, true, out);
    case 3: return VS_A(kDwBf16, kActNone, true, out);
    case 4: e = VS_A(kDwShift, kActNone, false, hmid); break;
    case 5: e = VS_A(kDwShift, kActErf, false, hmid); break;
    case 6: e = VS_A(kDwShift, kActSigmoid, false, hmid); break;
    case 7: e = VS_A(kDwShift, kActTanh, false, hmid); break;
    case 8: e = VS_A(kDwBf16, kActTanh, false, hmid); break;
    case 9: e = VS_A(kDwPerDy, kActErf, false, hmid); break;  // K2's own part (a)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VS_A
  if (e != 0) return e;
  return launch_b<T>(hmid, part, gamma, beta, w2, b2, xpad, out, B, H, W, C, P, stream);
}
