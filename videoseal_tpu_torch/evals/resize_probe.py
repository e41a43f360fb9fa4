"""Probe: planar u8 -> processing-size resize formulations (perf tool, not a
serving path), counterpart of ``videoseal_tpu/evals/resize_probe.py``.

``kernels/fused_planar.resize_planar`` casts the (F, 3, 1088, 2048) u8
planes to float32 before its two matmuls: a full-resolution float32 copy
(~27 MB a frame). The variants time the contraction order and the dtype of
that cast, on the JAX probe's antialiased resize matrices (rounded to bf16,
as its are):

  current_f32   float32 planes / 255, height then width matmul, float32;
  bf16_h_first  bf16 planes, height then width matmul in bf16;
  bf16_w_first  bf16 planes, width then height matmul in bf16;
  i8_w_first    the width product as an int8 matrix product with int32
                sums (planes >> 1 as int8 against the width matrix * 64
                rounded to int8; ``torch._int_mm``), then the height one in
                bf16: a traffic probe, as in JAX, whose values are not the
                resize's.

No kernel of the port's: cuBLAS (cuBLASLt's int8 product for the last),
as the JAX probe's are XLA's. Prints one JSON line a variant, the JAX
probe's keys: ``{"variant", "ms", "per_frame_us"}``.

  python -m videoseal_tpu_torch.evals.resize_probe [--frames 128] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.resize import resize_matrix
from ..utils.timing import cuda_ms, device_info, host_ms


def variants(x: torch.Tensor, s: int) -> dict:
    """name -> fn() over the u8 planes x (F, 3, H, W), each -> (F, s, s, 3)."""
    f, _, h, w = x.shape
    mh = resize_matrix(h, s, True, torch.bfloat16, x.device)
    mw = resize_matrix(w, s, True, torch.bfloat16, x.device)
    mh32, mw32 = mh.float(), mw.float()
    # (s, W) int8, its transpose a column-major (W, s) operand for _int_mm
    mw_i8 = torch.round(mw32 * 64).to(torch.int8)

    def current_f32():
        y = x.float() * (1.0 / 255.0)
        y = torch.einsum("Hh,fchw->fcHw", mh32, y)
        return torch.einsum("Ww,fchw->fchW", mw32, y).permute(0, 2, 3, 1)

    def bf16_h_first():
        y = torch.einsum("Hh,fchw->fcHw", mh, x.to(torch.bfloat16))
        y = torch.einsum("Ww,fchw->fchW", mw, y)
        return y.permute(0, 2, 3, 1).float() * (1 / 255.0)

    def bf16_w_first():
        y = torch.einsum("Ww,fchw->fchW", mw, x.to(torch.bfloat16))
        y = torch.einsum("Hh,fchw->fcHw", mh, y)
        return y.permute(0, 2, 3, 1).float() * (1 / 255.0)

    def i8_w_first():
        yi = (x >> 1).view(torch.int8).reshape(f * 3 * h, w)
        z = torch._int_mm(yi, mw_i8.t()).reshape(f, 3, h, s).to(torch.bfloat16)
        return torch.einsum("Hh,fchw->fcHw", mh, z).permute(0, 2, 3, 1)

    return {"current_f32": current_f32, "bf16_h_first": bf16_h_first,
            "bf16_w_first": bf16_w_first, "i8_w_first": i8_w_first}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--h", type=int, default=1088)
    ap.add_argument("--w", type=int, default=2048)
    ap.add_argument("--s", type=int, default=256)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("resize_probe runs on the CUDA device by default and none is "
                           "available; pass --device cpu")
    print(json.dumps(device_info(dev)), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (args.frames, 3, args.h, args.w), generator=g, device=dev,
                      dtype=torch.uint8)
    timer = cuda_ms if dev.type == "cuda" else host_ms
    rows = []
    with torch.no_grad():
        for name, fn in variants(x, args.s).items():
            ms = timer(fn, args.k)
            rows.append({"variant": name, "ms": ms, "per_frame_us": ms * 1e3 / args.frames})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
