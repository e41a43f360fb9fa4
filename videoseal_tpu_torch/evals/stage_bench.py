"""Per-stage timing of the NHWC serving pipeline, counterpart of
``videoseal_tpu/evals/stage_bench.py``.

Each stage is the port's counterpart of the JAX tool's call of the same
name, on inputs drawn on the device from a seed: the folded UNet on the key
frames, the space-to-depth UNet on them at the schedule it infers and at
four given ones (``S2D_SCHEDULES``), the extractor on 256-px frames, the key frames' downscale and the
prediction's upscale, K5 (``fused_jnd_delta``) on u8 frames followed by the
u8 blend; with ``--decompose`` also the whole embed (full-resolution JND)
and detect, K5 alone, the blend alone and two copies that calibrate the
memory rate. Each stage runs `k` calls back to back after a warm-up,
between CUDA events on the card (``utils/timing.cuda_ms``), on the host
clock on the CPU. Prints a line naming the device, then one JSON line per
stage, ``{"stage", "ms", "per_frame_us"}``.

  python -m videoseal_tpu_torch.evals.stage_bench [--frames 128] [--decompose]

The JAX tool threads each call's result into the next call's input
(``_perturb``, a chained ``fori_loop``) so that XLA cannot hoist a loop
body that does not depend on the loop; eager PyTorch runs every call it is
given, so the calls here are plain. A schedule that the UNet cannot take
prints ``{"stage", "error"}`` in place of its time, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels.fused_blend import fused_jnd_delta
from ..kernels.unet_fused import unet_apply_fused
from ..kernels.unet_s2d import unet_apply_s2d
from ..models.videoseal import _DTYPES, detect_pipeline, embed_pipeline
from ..ops.resize import resize_bilinear
from ..utils.timing import cuda_ms, device_info, host_ms

# the JAX tool's watermark strength and image scale
SCALING_W, SCALING_I = 0.2, 1.0
# the s2d UNet's schedules the JAX tool times (None: the one it infers)
S2D_SCHEDULES = (None, (4, 2, 1, 1), (4, 4, 1, 1), (4, 4, 2, 1), (8, 4, 2, 1))


def draw_inputs(model, frames: int, height: int, width: int) -> dict:
    """The JAX tool's inputs, drawn on the model's device from seed 0: key
    frames at the processing size in the compute dtype, one message, u8
    frames, 256-px frames, a low-res prediction, a full-res prediction
    plane and a small delta plane."""
    cfg, dev = model.cfg, model.device
    cdt, s = _DTYPES[cfg.compute_dtype], cfg.img_size
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev).mul_(hi - lo).add_(lo)

    return {
        "keys": uniform((frames // cfg.step_size, s, s, 1 if cfg.yuv else 3)).to(cdt),
        "msgs": torch.randint(0, 2, (1, cfg.nbits), generator=g, device=dev),
        "frames_u8": torch.randint(0, 256, (frames, height, width, 3), generator=g,
                                   device=dev, dtype=torch.uint8),
        "frames256": uniform((frames, s, s, 3)).to(cdt),
        "preds1": uniform((frames, s, s, 1), -1.0),
        "predsf": uniform((frames, height, width), -1.0),
        "delta0": uniform((frames, height, width), -0.01, 0.01),
    }


def _blend_u8(frames: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    out = frames.float() + 255.0 * delta[..., None]
    return out.round_().clamp_(0.0, 255.0).to(torch.uint8)


def stages(model, inputs: dict, decompose: bool = False) -> list:
    """(name, fn) of each stage, the JAX tool's names; fn() computes the
    stage on `inputs` (``draw_inputs``' keys)."""
    cfg, x = model.cfg, inputs
    s, prec = cfg.img_size, cfg.resize_precision
    h, w = x["frames_u8"].shape[1:3]
    key_msgs = x["msgs"].expand(x["keys"].shape[0], -1)

    def full():
        imgs_w, _ = embed_pipeline(model.embedder, model.attenuation, cfg, x["frames_u8"],
                                   x["msgs"], SCALING_W, SCALING_I, is_video=True,
                                   lowres_attenuation=False)
        return imgs_w, detect_pipeline(model.extractor, cfg, imgs_w)

    unet = model.embedder.unet
    out = [("unet_fused(keys)", lambda: unet_apply_fused(unet, x["keys"], key_msgs))]
    out += [(f"unet_s2d{'inferred' if sch is None else sch}(keys)",
             lambda sch=sch: unet_apply_s2d(unet, x["keys"], key_msgs, sch))
            for sch in S2D_SCHEDULES]
    out += [
        ("extractor(frames@256)", lambda: detect_pipeline(model.extractor, cfg, x["frames256"])),
        ("resize_down(keys)", lambda: resize_bilinear(
            x["frames_u8"][::cfg.step_size].float(), s, s, precision=prec)),
        ("resize_up(preds)", lambda: resize_bilinear(x["preds1"], h, w, precision=prec)),
        ("fused_jnd_delta+blend(fullres)", lambda: _blend_u8(
            x["frames_u8"], fused_jnd_delta(x["frames_u8"], x["predsf"], SCALING_W))),
    ]
    if decompose:
        out += [
            ("full_embed_extract", full),
            ("fused_jnd_delta(only)",
             lambda: fused_jnd_delta(x["frames_u8"], x["predsf"], SCALING_W)),
            ("blend_elementwise(only)", lambda: _blend_u8(x["frames_u8"], x["delta0"])),
            ("hbm_copy_u8(frames)", lambda: x["frames_u8"].clone()),
            ("hbm_copy_f32(preds_plane)", lambda: x["predsf"] + 1.0),
        ]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--decompose", action="store_true",
                    help="also time the whole embed+detect, K5 and the blend alone, and "
                         "two copies that calibrate the memory rate")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.cfg import load

    model = load(args.card, device=args.device).with_dtype("bfloat16")
    inputs = draw_inputs(model, args.frames, args.height, args.width)
    timer = cuda_ms if model.device.type == "cuda" else host_ms
    info = device_info(model.device)
    print(json.dumps(info), flush=True)
    rows = []
    with torch.no_grad():
        for name, fn in stages(model, inputs, args.decompose):
            try:
                ms = timer(fn, args.k)
            except ValueError as ex:
                if not name.startswith("unet_s2d"):
                    raise
                # a schedule the UNet cannot take (schedule_for, pack_conv)
                rows.append({"stage": name.removesuffix("(keys)"), "error": str(ex)[:200]})
            else:
                rows.append({"stage": name, "ms": ms, "per_frame_us": ms * 1e3 / args.frames})
            print(json.dumps(rows[-1]), flush=True)
    return {**info, "stages": rows}


if __name__ == "__main__":
    main()
