// K7: the attribution probe of the strip kernel (jnd_delta.cuh) that K6
// runs, in K5's delta form: the instances with the heat switched and the
// strip height swept. vs_jnd_probe(mode = 3, rs = 8) is K5's earlier strip
// design, the parent of its row-streaming kernel (jnd_rows.cuh): the same
// delta bit for bit.
//
// Replaces videoseal_tpu/kernels/jnd_probe.py::run (body _build): K5's
// epilogue, with the heat switched by HM (jnd_heat.cuh: copy, sums, sqrt,
// and the production cm2^1.2) and the strip height R swept over 4, 8, 16, 32
// (the TPU probe swept its row tile). copy writes sw * lum(y, x - 2) + pred:
// the TPU probe's read of its padded plane two columns left of the centre,
// mirrored exactly.

#include "jnd_delta.cuh"

namespace {

template <int R, int HM>
int probe(const void* img, int img_u8, const void* pred, void* out, int F, int H, int W,
          float c0, float c1, float c2, float sw, void* stream) {
  if (img_u8)
    return launch<kDelta, uint8_t, float, 1, R, HM>(img, pred, out, F, H, W, c0, c1, c2, 0.f,
                                                    sw, stream);
  return launch<kDelta, float, float, 1, R, HM>(img, pred, out, F, H, W, c0, c1, c2, 0.f, sw,
                                                stream);
}

template <int HM>
int probe_rs(int rs, const void* img, int img_u8, const void* pred, void* out, int F, int H,
             int W, float c0, float c1, float c2, float sw, void* stream) {
  switch (rs) {
    case 4: return probe<4, HM>(img, img_u8, pred, out, F, H, W, c0, c1, c2, sw, stream);
    case 8: return probe<8, HM>(img, img_u8, pred, out, F, H, W, c0, c1, c2, sw, stream);
    case 16: return probe<16, HM>(img, img_u8, pred, out, F, H, W, c0, c1, c2, sw, stream);
    case 32: return probe<32, HM>(img, img_u8, pred, out, F, H, W, c0, c1, c2, sw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K7. mode: jnd_heat.cuh's HeatMode (copy 0, sums 1, sqrt 2, production 3);
// rs: rows per block, 4, 8, 16 or 32; the rest as K5.
extern "C" int vs_jnd_probe(const void* img, int img_u8, const void* pred, void* out, int F,
                            int H, int W, float c0, float c1, float c2, float sw, int mode,
                            int rs, void* stream) {
  switch (mode) {
    case kHeatCopy:
      return probe_rs<kHeatCopy>(rs, img, img_u8, pred, out, F, H, W, c0, c1, c2, sw, stream);
    case kHeatSums:
      return probe_rs<kHeatSums>(rs, img, img_u8, pred, out, F, H, W, c0, c1, c2, sw, stream);
    case kHeatSqrt:
      return probe_rs<kHeatSqrt>(rs, img, img_u8, pred, out, F, H, W, c0, c1, c2, sw, stream);
    case kHeatNoSqrt:
      return probe_rs<kHeatNoSqrt>(rs, img, img_u8, pred, out, F, H, W, c0, c1, c2, sw,
                                   stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
