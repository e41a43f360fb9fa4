"""Attribution of the planar blend's and the extractor's routes (perf tool,
not a serving path), counterpart of ``videoseal_tpu/evals/r4_probe.py``.

Each stage alone on videoseal_1.0 in bf16 at random init, on inputs drawn on
the device from a seed:

  blend             K1 (``fused_jnd_blend_planar``), full-resolution JND,
                    no detect output;
  blend+detect      K1 with the detect output (detect_size = the card's
                    processing size): the scored mode's downscale inside the
                    kernel;
  resize_det        the separate detect-side resize it replaces
                    (``resize_planar`` of K1's output, bf16);
  extractor_multi   the extractor on frames at the processing size, the
                    ConvNeXt's blocks in groups of up to 4 (K3, and K2 for
                    a group of one) and the pixel decoder;
  extractor_single  the same, every block a K2 launch (max_block_group=1,
                    the card's default route).

Prints one JSON line a stage, the JAX probe's keys: ``{"stage", "ms",
"per_frame_us"}``.

  python -m videoseal_tpu_torch.evals.r4_probe [--stages blend,extract] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import fused_planar as fp
from ..kernels.convnext_fused import convnext_apply_fused
from ..kernels.fused_planar import fused_jnd_blend_planar
from ..models.videoseal import _chunked_apply
from ..utils.timing import cuda_ms, device_info, host_ms

# the JAX probe's strength and scale
SCALING_W, SCALING_I = 0.2, 1.0


def extract(ext, frames: torch.Tensor, max_block_group: int, chunk: int) -> torch.Tensor:
    """The extractor's logits (float32) over `frames` (F, s, s, 3) in [0, 1],
    `chunk` frames a call, its ConvNeXt's blocks in groups of up to
    `max_block_group`."""
    with torch.no_grad():
        return _chunked_apply(lambda b: ext.pixel_decoder(convnext_apply_fused(
            ext.convnext, b[0] * 2 - 1, max_block_group=max_block_group)).float(),
            (frames,), chunk)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--stages", default="blend,extract")
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")

    from ..utils.cfg import load

    model = load(args.card, device=args.device).with_dtype("bfloat16")
    dev, cfg = model.device, model.cfg
    s, f, h, w = cfg.img_size, args.frames, args.height, args.width
    timer = cuda_ms if dev.type == "cuda" else host_ms
    print(json.dumps(device_info(dev)), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def report(stage: str, ms: float):
        rows.append({"stage": stage, "ms": ms, "per_frame_us": ms * 1e3 / f})
        print(json.dumps(rows[-1]), flush=True)

    if "blend" in stages:
        imgs_p = fp.pack_planar(torch.randint(0, 256, (f, h, w, 3), generator=g, device=dev,
                                              dtype=torch.uint8))
        preds = torch.rand((f, s, s), generator=g, device=dev) * 2 - 1
        blend = lambda ds=None: fused_jnd_blend_planar(imgs_p, preds, SCALING_W, SCALING_I,
                                                       h, w, detect_size=ds)
        report("blend", timer(blend, args.k))
        report("blend+detect", timer(lambda: blend(s), args.k))
        wm_p = blend()
        report("resize_det", timer(lambda: fp.resize_planar(wm_p, h, w, s, s, r0=0, c0=0,
                                                            precision="default"), args.k))
        del imgs_p, wm_p
    if "extract" in stages:
        frames = torch.rand((f, s, s, 3), generator=g, device=dev).to(torch.bfloat16)
        for name, mbg in (("extractor_multi", 4), ("extractor_single", 1)):
            report(name, timer(lambda: extract(model.extractor, frames, mbg, cfg.chunk_size),
                               args.k))
    return rows


if __name__ == "__main__":
    main()
