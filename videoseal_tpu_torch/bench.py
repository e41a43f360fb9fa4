"""The port's scorer: 1080p frames a second through embed + detect with the
flagship card, the counterpart of the repo's root ``bench.py``.

Protocol (root bench.py's): videoseal_1.0 in bf16 watermarks 128 1080p u8
frames held on the device (chunked temporal propagation, JND attenuation)
and runs the extractor over the watermarked frames, in one call:

- planar layout: ``VideoSeal.embed_detect_planar`` over a padded planar
  buffer, in the scored mode (lowres attenuation, the detect input made in
  the blend kernel) and in the other JND mode, which the line reports
  beside it;
- NHWC layout: ``VideoSeal.embed`` of the frames as a video, then
  ``VideoSeal.detect`` of the watermarked frames.

Every call recomputes everything: the key frames' predictions, the blend,
the detect input and the extractor. Timing: one warm-up call, then per
repeat k = max(runs, 4) calls back to back between two CUDA events (no
host sync is issued inside the window); fps = frames / (ms a call); the
median repeat is `value`. One JSON line with root bench.py's keys; it has
no `vs_baseline`, since that target was set for a TPU.

    python -m videoseal_tpu_torch.bench [--layout nhwc] [--frames 32]

It runs on the card unless --device cpu is given; a kernel that does not
build fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("videoseal_tpu_torch.bench")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--runs", type=int, default=5,
                    help="calls a repeat times (at least 4)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="independent timed repeats; the median is reported")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--card", default="videoseal_1.0", help="a card's name or a card file")
    ap.add_argument("--dtype", default="bfloat16",
                    help="model compute dtype (the full-res blend stays f32)")
    ap.add_argument("--lowres_attenuation", type=int, default=1,
                    help="JND at processing resolution (the scored planar mode); the "
                         "full-res JND mode is measured and reported alongside it")
    ap.add_argument("--frame_dtype", default="uint8", choices=["uint8", "float32"])
    ap.add_argument("--layout", default="planar", choices=["planar", "nhwc"],
                    help="u8 frame layout: padded planar RGB or interleaved NHWC")
    ap.add_argument("--fused_detect", type=int, default=None,
                    help="planar: make the extractor's input inside the blend kernel "
                         "(default: on in lowres mode, off in full-res mode)")
    ap.add_argument("--trace_dir", default=None,
                    help="after measuring, write a torch.profiler trace of one call of "
                         "the scored mode to <trace_dir>/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises where there is none) or cpu")
    return ap


def _frames(args, planar: bool, device: torch.device, rng: np.random.Generator):
    """The frames root bench.py draws from `rng`, on `device`."""
    f, h, w = args.frames, args.height, args.width
    if planar:
        # padded planar RGB u8, the layout the native decoder fills
        from .kernels.fused_planar import C0, R0, planar_shape
        buf = np.zeros(planar_shape(f, h, w), np.uint8)
        buf[:, :, R0:R0 + h, C0:C0 + w] = rng.integers(0, 256, (f, 3, h, w), np.uint8)
        return torch.as_tensor(buf, device=device)
    if args.frame_dtype == "uint8":
        return torch.as_tensor(rng.integers(0, 256, (f, h, w, 3)).astype(np.uint8),
                               device=device)
    return torch.as_tensor(rng.uniform(0, 1, (f, h, w, 3)).astype(np.float32), device=device)


def _timed_ms(call, k: int, device: torch.device) -> float:
    """ms a call over k calls back to back: CUDA events on the card (the
    host waits only after the end event), the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k
    t0 = time.perf_counter()
    for _ in range(k):
        call()
    return (time.perf_counter() - t0) * 1e3 / k


def measure(call, frames: int, runs: int, repeats: int,
            device: torch.device) -> tuple[float, list, float]:
    """(median fps, every repeat's fps in order, spread in % of the median)
    of `call` after one warm-up call."""
    call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    k = max(runs, 4)
    fpss = sorted(frames / _timed_ms(call, k, device) * 1e3 for _ in range(repeats))
    fps = fpss[len(fpss) // 2]
    return fps, fpss, (fpss[-1] - fpss[0]) / fps * 100.0


def main(argv=None) -> dict:
    """Measure as the flags say; print the JSON line and return it as a dict."""
    args = get_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench runs on the CUDA device by default and none is available; "
                           "pass --device cpu to run it on the CPU")
    from .utils.cfg import load

    model = load(args.card, device=device, seed=0)
    if args.dtype != "float32":
        model = model.with_dtype(args.dtype)
    lowres = bool(args.lowres_attenuation)
    planar = args.frame_dtype == "uint8" and args.layout == "planar"
    h, w = args.height, args.width
    rng = np.random.default_rng(0)
    frames = _frames(args, planar, device, rng)
    msgs = torch.as_tensor(rng.integers(0, 2, (1, model.nbits)), dtype=torch.int32,
                           device=device)

    def make_call(lowres_mode: bool):
        if planar:
            fused = lowres_mode if args.fused_detect is None else bool(args.fused_detect)
            return lambda: model.embed_detect_planar(frames, h, w, msgs=msgs,
                                                     lowres_attenuation=lowres_mode,
                                                     fused_detect=fused)

        def embed_detect():
            imgs_w = model.embed(frames, msgs=msgs, is_video=True,
                                 lowres_attenuation=lowres_mode)["imgs_w"]
            return model.detect(imgs_w, is_video=True)

        return embed_detect

    call = make_call(lowres)
    fps, fpss, spread = measure(call, args.frames, args.runs, args.repeats, device)
    result = {
        "metric": f"{args.height}p_frames_per_sec_embed_extract",
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "runs": [round(f, 1) for f in fpss],
        "spread_pct": round(spread, 2),
    }
    if planar:
        # both JND placements in the one line: the scored mode, and the
        # other measured alongside
        fps_o, fpss_o, _ = measure(make_call(not lowres), args.frames, args.runs,
                                   args.repeats, device)
        result["mode"] = "lowres_attenuation" if lowres else "fullres_jnd"
        key = "fullres_jnd_fps" if lowres else "lowres_attenuation_fps"
        result[key] = round(fps_o, 2)
        result[key.replace("_fps", "_runs")] = [round(f, 1) for f in fpss_o]
    print(json.dumps(result), flush=True)

    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            call()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "trace.json"))
    return result


if __name__ == "__main__":
    main()
