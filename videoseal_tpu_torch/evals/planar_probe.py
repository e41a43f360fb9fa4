"""K1's block geometry, and the lowres mode's pieces (perf tool, not a
serving path), counterpart of ``videoseal_tpu/evals/planar_probe.py``.

The JAX probe times its planar kernel at a TPU tile height ``--th`` (the
rows a grid step writes, which also fixes the planar buffer's layout). The
port keeps the JAX package's layout, TH = 96 (``kernels/fused_planar.py``),
so ``--th`` takes 96 and refuses any other value. The Hopper kernel's own
geometry is the output rows a block, ``rs`` (``fused_planar.RS``): the probe
times K1 (full-resolution JND, no detect output) at each rs of ``--rs``
that its shared memory takes (``fused_planar.k1_smem``; another prints
``{"th", "tin", "rs", "error"}``), each output held bit for bit against the
default rs's. Prints one JSON line a rs, ``{"th", "tin", "rs", "ms",
"per_frame_us"}``.

With ``--lowres_stages``, the lowres mode's pieces too: K1's lowres
branch ("blend_lowres"), the JND heatmaps at the processing size
("jnd_heatmaps_procres") and ``resize_planar`` of every frame
("resize_planar_allframes"), ``{"stage", "ms", "per_frame_us"}`` (the
first with "th").

  python -m videoseal_tpu_torch.evals.planar_probe [--rs 16,32,64] [--lowres_stages]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import fused_planar as fp
from ..kernels.fused_planar import fused_jnd_blend_planar
from ..modules.jnd import build_attenuation
from ..utils.timing import cuda_ms, device_info, host_ms

# the JAX probe's strength and scale
SCALING_W, SCALING_I = 0.2, 1.0


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--th", type=int, default=fp.TH)
    ap.add_argument("--rs", default="8,16,32,64,128", help="K1's output rows a block to time")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--proc", type=int, default=256)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--lowres_stages", action="store_true",
                    help="also time the lowres-attenuation mode's pieces: the lowres blend, "
                         "the proc-res JND heatmaps, the all-frames resize")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.th != fp.TH:
        raise ValueError(f"--th {args.th}: the port keeps the JAX package's planar layout, "
                         f"whose tile height is {fp.TH}; K1's own block height is --rs")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("planar_probe runs on the CUDA device by default and none is "
                           "available; pass --device cpu")
    print(json.dumps(device_info(dev)), flush=True)
    timer = cuda_ms if dev.type == "cuda" else host_ms
    f, h, w, s = args.frames, args.height, args.width, args.proc
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (f, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
    imgs_p = fp.pack_planar(frames)
    del frames
    preds = torch.rand((f, s, s), generator=g, device=dev) * 2 - 1

    def blend(rs: int = fp.RS, lowres: bool = False):
        return fused_jnd_blend_planar(imgs_p, preds, SCALING_W, SCALING_I, h, w,
                                      lowres=lowres, rs=rs)

    rows = []

    def report(rec: dict, ms: float):
        rows.append({**rec, "ms": ms, "per_frame_us": ms * 1e3 / f})
        print(json.dumps(rows[-1]), flush=True)

    ref = blend()
    for rs in (int(r) for r in args.rs.split(",")):
        smem = fp.k1_smem(s, h, w, 0, False, rs)
        if smem > fp.SMEM_MAX:
            rows.append({"th": fp.TH, "tin": fp.TIN, "rs": rs,
                         "error": f"{smem} bytes of shared memory a block"})
            print(json.dumps(rows[-1]), flush=True)
            continue
        if not torch.equal(blend(rs), ref):
            raise AssertionError(f"K1 at rs={rs} differs from K1 at rs={fp.RS}")
        report({"th": fp.TH, "tin": fp.TIN, "rs": rs}, timer(lambda: blend(rs), args.k))
    del ref
    if not args.lowres_stages:
        return rows

    report({"stage": "blend_lowres", "th": fp.TH}, timer(lambda: blend(lowres=True), args.k))
    att = build_attenuation("jnd_1_1")
    frames_res = torch.rand((f, s, s, 3), generator=g, device=dev)
    with torch.no_grad():
        report({"stage": "jnd_heatmaps_procres"},
               timer(lambda: att.heatmaps(frames_res), args.k))
    report({"stage": "resize_planar_allframes"},
           timer(lambda: fp.resize_planar(imgs_p, h, w, s, s, precision="default"), args.k))
    return rows


if __name__ == "__main__":
    main()
