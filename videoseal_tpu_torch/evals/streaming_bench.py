"""End-to-end streaming throughput: decode -> embed on the card -> encode.

Counterpart of ``videoseal_tpu/evals/streaming_bench.py``. Synthesizes a
test video with the native encoder, then measures:

  decode_fps     native planar decode alone (host)
  encode_fps     native planar encode alone (host)
  device_fps     the device stage alone: each decoded chunk copied to the
                 card through a pinned buffer, embedded (``embed_planar``,
                 one K1 launch) and copied back (real model only)
  stream_fps     ``embed_video_planar`` wall clock, the three stages
                 overlapped through the stream engine's queues
  overlap_ratio  sum(stage walls) / stream wall: above 1 when the stages
                 overlap; the stream is bound by its slowest stage when the
                 wall comes near that stage's

and, from the engine's CUDA events, the copies' and kernels' device time
and how much of the copies ran under kernels.

  python -m videoseal_tpu_torch.evals.streaming_bench [--height 1080 --width 1920]
      [--frames 96] [--card videoseal_1.0] [--stub_device_fps N]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import native
from ..kernels.fused_planar import C0, R0


def synth_frames(frames: int, h: int, w: int, seed: int = 0):
    """The synthetic clip's RGB u8 frames, one at a time: a colour ramp
    whose brightness varies over time, with noise (a bank of 8 noise
    frames, so that a 1080p clip takes no longer to make than to encode)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([yy / h, xx / w, (xx + yy) / (h + w)], -1)
    noise = [rng.standard_normal(base.shape, dtype=np.float32) * 0.03
             for _ in range(min(frames, 8))]
    for i in range(frames):
        img = base * np.float32(0.6 + 0.4 * np.sin(i / 7.0)) + noise[i % len(noise)]
        yield np.clip(img * 255, 0, 255).astype(np.uint8)


def synth_video(path: str, frames: int, h: int, w: int, crf: int = 23) -> None:
    """Write the synthetic clip (native libx264 at `crf`, or cv2's mp4v where
    the native runtime did not load)."""
    from ..inference_streaming import open_writer

    wr = open_writer(path, w, h, 24, crf=crf)
    try:
        for fr in synth_frames(frames, h, w):
            wr.write(fr[None])
    finally:
        wr.close()


class _StubDevice:
    """A device stand-in: embed_planar sleeps chunk / fps seconds and returns
    the input image moved to rows [0, h), cols [0, w) (the output layout).
    With it, the stream's wall must approach the slowest of decode, stub and
    encode, not their sum."""

    supports_planar = True
    device = torch.device("cpu")

    def __init__(self, fps: float):
        self.fps = fps

    def get_random_msg(self, n):
        return torch.zeros((n, 8), dtype=torch.int32)

    def embed_planar(self, chunk, h, w, msgs=None, lowres_attenuation=None):
        time.sleep(chunk.shape[0] / self.fps)
        out = torch.zeros_like(chunk)
        out[:, :, :h, :w] = chunk[:, :, R0:R0 + h, C0:C0 + w]
        return {"imgs_w": out, "msgs": msgs}


def decode_stage(path: str, chunk: int) -> tuple[list, float]:
    """Every planar chunk of the file, and the seconds the decode took."""
    t0 = time.perf_counter()
    chunks = []
    with native.VideoReader(path) as r:
        while True:
            c = r.read_planar(chunk)
            if c.shape[0] == 0:
                break
            chunks.append(c)
    return chunks, time.perf_counter() - t0


def encode_stage(chunks: list, path: str, h: int, w: int) -> float:
    """Seconds to encode the chunks' images (libx264, crf 18)."""
    t0 = time.perf_counter()
    with native.VideoWriter(path, w, h, codec="h264", crf=18, fps=24) as wr:
        for c in chunks:
            wr.write_planar(c, r0=R0, c0=C0)
    return time.perf_counter() - t0


def device_stage(step, chunks: list, device, reps: int = 1) -> float:
    """Seconds per pass of the device stage alone: each chunk from a pinned
    buffer to the card, step(x) (the stream's device work), and the result
    back to a pinned buffer, the host waiting at the end (after a warm-up
    pass). On the CPU, no copies."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    staged = [torch.from_numpy(c).pin_memory() if cuda else torch.from_numpy(c)
              for c in chunks]
    outs = {}

    def one_pass():
        for i, p in enumerate(staged):
            y = step(p.to(dev, non_blocking=True))
            if i not in outs:
                outs[i] = torch.empty(y.shape, dtype=y.dtype, pin_memory=cuda)
            outs[i].copy_(y, non_blocking=True)
        if cuda:
            torch.cuda.synchronize(dev)

    one_pass()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_pass()
    return (time.perf_counter() - t0) / reps


def planar_step(model, h: int, w: int, msgs, lowres_attenuation: bool = True):
    """The planar stream's device work: embed_planar of a chunk."""
    return lambda x: model.embed_planar(x, h, w, msgs=msgs,
                                        lowres_attenuation=lowres_attenuation)["imgs_w"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stub_device_fps", type=float, default=0,
                    help="replace the device stage with a host-side sleep sustaining N "
                         "fps: measures the queues' overlap alone (0: the real model)")
    args = ap.parse_args(argv)

    from ..inference_streaming import embed_video_planar
    from ..utils.cfg import load

    if not native.available():
        raise RuntimeError(f"the native media runtime is required: {native.last_error()}")
    h, w = args.height, args.width
    with tempfile.TemporaryDirectory(prefix="vsm_stream_") as tmp:
        src, dst = os.path.join(tmp, "src.mp4"), os.path.join(tmp, "wm.mp4")
        synth_video(src, args.frames, h, w)
        chunks, t_dec = decode_stage(src, args.chunk)
        n = sum(c.shape[0] for c in chunks)
        t_enc = encode_stage(chunks, os.path.join(tmp, "copy.mp4"), h, w)
        if args.stub_device_fps > 0:
            model = _StubDevice(args.stub_device_fps)
            t_dev = n / args.stub_device_fps
        else:
            model = load(args.card, device=args.device).with_dtype("bfloat16")
            t_dev = device_stage(planar_step(model, h, w, model.get_random_msg(1)), chunks,
                                 model.device)
        out = embed_video_planar(model, src, dst, chunk_size=args.chunk)
    t_stream = out["stats"]["wall_s"]
    if out["frames"] != n:
        raise RuntimeError(f"the stream embedded {out['frames']} frames of {n}")
    walls = [t_dec, t_enc, t_dev]
    result = {
        "height": h, "width": w, "frames": n,
        "decode_fps": n / t_dec, "encode_fps": n / t_enc, "device_fps": n / t_dev,
        "stream_fps": n / t_stream, "overlap_ratio": sum(walls) / t_stream,
        "stream_vs_slowest_stage": t_stream / max(walls),
        "engine": {k: v for k, v in out["stats"].items() if k != "wall_s"},
        "device": ("stub" if args.stub_device_fps > 0
                   else torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu"),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
