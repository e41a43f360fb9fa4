"""Speed harness, counterpart of ``videoseal_tpu/evals/speed.py``.

Times embed and extract separately (ms per frame) with CUDA events
(``utils/timing.cuda_ms``) on the card; a model the caller built on the CPU
is timed with the host clock, and the result names the device either way.
With a trace directory, one warm embed+extract pass runs under
``torch.profiler`` and its Chrome trace is written there.

  python -m videoseal_tpu_torch.evals.speed --card videoseal_1.0 --num_frames 64

The function is ``test_speed``, the JAX package's name; import the module,
not the name, into a test file, or pytest collects it as a test.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..utils.timing import cuda_ms, host_ms


def test_speed(model, frames, num_runs: int = 8, is_video: bool = True,
               trace_dir: str | None = None) -> dict:
    """Timed embed (full-resolution JND) and extract of float frames in
    [0, 1], (F, H, W, 3), on the model's device."""
    from ..models.videoseal import detect_pipeline, embed_pipeline

    frames = torch.as_tensor(frames, device=model.device).float().contiguous()
    msgs = model.get_random_msg(1 if is_video else frames.shape[0])

    def embed_once():
        return embed_pipeline(model.embedder, model.attenuation, model.cfg, frames, msgs,
                              model.scaling_w, model.scaling_i, is_video=is_video,
                              lowres_attenuation=False)[0]

    def extract_once():
        return detect_pipeline(model.extractor, model.cfg, frames)

    cuda = model.device.type == "cuda"
    timer = cuda_ms if cuda else host_ms
    t_embed = timer(embed_once, num_runs) / 1e3
    t_extract = timer(extract_once, num_runs) / 1e3

    if trace_dir:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("embed"):
                out = embed_once()
            with record_function("extract"):
                extract_once()
            if cuda:
                torch.cuda.synchronize()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "speed_trace.json"))
        del out

    f = frames.shape[0]
    return {
        "device": torch.cuda.get_device_name(model.device) if cuda else "cpu",
        "frames": f,
        "embed_ms_per_frame": 1e3 * t_embed / f,
        "extract_ms_per_frame": 1e3 * t_extract / f,
        "embed_fps": f / t_embed,
        "extract_fps": f / t_extract,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num_frames", type=int, default=64)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--num_runs", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace_dir", default=None,
                    help="write a torch.profiler Chrome trace of one embed+extract there")
    args = ap.parse_args(argv)

    from ..utils.cfg import load

    model = load(args.card, checkpoint=args.checkpoint, device=args.device)
    if args.dtype != "float32":
        model = model.with_dtype(args.dtype)
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (args.num_frames, args.height, args.width, 3)).astype(np.float32)
    stats = test_speed(model, frames, args.num_runs, trace_dir=args.trace_dir)
    print(json.dumps({"card": args.card, "dtype": args.dtype,
                      "resolution": f"{args.height}x{args.width}", **stats}))


if __name__ == "__main__":
    main()
