"""Streaming video watermark embedding and detection on the card.

Counterpart of ``videoseal_tpu/inference_streaming.py``. One stream engine
(`run_stream`) serves every entry point: a decoder thread fills chunks of
frames, the main thread copies each chunk to the device and launches its
kernels, and a writer thread consumes the results. Host and device meet
in two pairs of reused pinned staging buffers, one pair a direction; the
copies run on their own CUDA streams, and the next chunk's copy in is
issued before the current chunk's kernels when the decoder has it ready,
so that the copies can run under the kernels. Each chunk's copy out is
waited on only after the next chunk has been taken from the decoder and
this one launched. CUDA work stays on the main thread; the
worker threads touch numpy only, and the native calls release the
interpreter lock.

  * `embed_video_planar`: the native decoder writes the padded planar u8
    layout, one K1 launch blends each chunk (``VideoSeal.embed_planar``),
    the native encoder (libx264) reads the planar output;
  * `embed_video`: the planar path where the card supports it and the native
    runtime loaded; else NHWC frames (RGB u8 read as float / 255, as the JAX
    package reads them) through ``VideoSeal.embed`` and written with
    ``clip(x * 255 + 0.5)``. Frames are read with the native reader, or with
    cv2 where the native runtime did not load;
  * `detect_video`: NHWC frames through ``VideoSeal.detect``, the logits
    aggregated into the video's message.

  python -m videoseal_tpu_torch.inference_streaming --input in.mp4 --output out.mp4 \\
      [--card videoseal_1.0] [--checkpoint ckpt.npz] [--detect 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np
import torch

from . import native
from .kernels.fused_planar import planar_shape
from .models.videoseal import aggregate_message

_BUFFERS = 2      # staging buffers a direction
_POLL_S = 0.1     # how often a blocked queue read looks for a worker's failure


def _backend() -> str:
    """"native" where the native runtime loaded, else "cv2" where it imports."""
    if native.available():
        return "native"
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise RuntimeError("no video I/O: the native media runtime did not load "
                           f"({native.last_error()}) and cv2 is not installed") from None
    return "cv2"


class _Failed(Exception):
    """A worker thread's failure, re-raised on the main thread."""


def _get(q: queue.Queue, errors: list):
    while True:
        if errors:
            raise _Failed("a stream worker failed") from errors[0]
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            continue


def _interval_overlap(a: list, b: list) -> float:
    """Total length of the intersections of intervals `a` with intervals `b`
    (each list of (start, end), `b` disjoint)."""
    return sum(max(0.0, min(e0, e1) - max(s0, s1)) for s0, e0 in a for s1, e1 in b)


def run_stream(fill, chunk_shape: tuple, step, sink, device="cuda") -> dict:
    """The stream engine.

    fill(buf) -> n, on the decoder thread: write up to buf.shape[0] frames
    into the numpy u8 array `buf` (a staging buffer of `chunk_shape`, reused:
    what fill does not write keeps its earlier contents) and return how many,
    0 at the end. step(x) -> y, on the main thread: the device work for the
    (n, ...) u8 chunk `x` on `device`, returning a tensor of n rows.
    sink(arr), on the writer thread: consume a chunk's result as numpy.

    Returns the frame and chunk counts, the wall time and, on CUDA, the
    device timeline from events: each direction's copy time, the kernels'
    time, how much of the copies ran while kernels ran, and the span from
    the first copy in to the last copy out."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    free_in: queue.Queue = queue.Queue()
    for _ in range(_BUFFERS):
        free_in.put(torch.zeros(chunk_shape, dtype=torch.uint8, pin_memory=cuda))
    in_q: queue.Queue = queue.Queue()
    free_out: queue.Queue = queue.Queue()
    out_q: queue.Queue = queue.Queue()
    errors: list = []

    def decoder():
        try:
            while True:
                buf = free_in.get()
                if buf is None:
                    return
                n = fill(buf.numpy())
                in_q.put((buf, n) if n else None)
                if not n:
                    return
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    def writer():
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                buf, n = item
                sink(buf[:n].numpy())
                free_out.put(buf)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=decoder, daemon=True),
               threading.Thread(target=writer, daemon=True)]
    for t in threads:
        t.start()
    if cuda:
        compute = torch.cuda.current_stream(device)
        s_in, s_out = torch.cuda.Stream(device), torch.cuda.Stream(device)
    timeline = []     # per chunk: the six events of its copies and kernels
    out_bufs = 0
    pending = None    # (event, buffer, n) of the chunk whose copy out is in flight
    frames = chunks = 0

    def copy_in(item):
        """Issue a chunk's copy to the device: (buffer, n, tensor, events)."""
        buf, n = item
        if not cuda:
            return buf, n, buf[:n], None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        with torch.cuda.stream(s_in):
            ev[0].record()
            x = buf[:n].to(device, non_blocking=True)
            ev[1].record()
        return buf, n, x, ev

    t0 = time.perf_counter()
    try:
        item = _get(in_q, errors)
        cur = copy_in(item) if item is not None else None
        while cur is not None:
            buf, n, x, ev = cur
            # the next chunk, if the decoder has it ready: its copy in is
            # issued before this chunk's kernels, so that it runs under them
            try:
                item, ready = in_q.get_nowait(), True
            except queue.Empty:
                item, ready = None, False
            nxt = copy_in(item) if item is not None else None
            if cuda:
                compute.wait_event(ev[1])
                x.record_stream(compute)
                ev[2].record(compute)
                y = step(x)
                ev[3].record(compute)
            else:
                y = step(x)
            if y.shape[0] != n:
                raise ValueError(f"step returned {y.shape[0]} rows for a chunk of {n}")
            if out_bufs < _BUFFERS:
                out_bufs += 1
                free_out.put(torch.empty((chunk_shape[0],) + tuple(y.shape[1:]),
                                         dtype=y.dtype, pin_memory=cuda))
            ob = _get(free_out, errors)
            if cuda:
                s_out.wait_event(ev[3])
                with torch.cuda.stream(s_out):
                    ev[4].record()
                    ob[:n].copy_(y, non_blocking=True)
                    ev[5].record()
                y.record_stream(s_out)
                timeline.append(ev)
                ev[1].synchronize()      # the chunk is on the device: its buffer is free
                done = ev[5]
            else:
                ob[:n].copy_(y)
                done = None
            free_in.put(buf)
            # the previous chunk's copy out is waited on only now, after the
            # next chunk was taken from the decoder and this one launched
            if pending is not None:
                if pending[0] is not None:
                    pending[0].synchronize()
                out_q.put(pending[1:])
            pending = (done, ob, n)
            frames += n
            chunks += 1
            if not ready:
                item = _get(in_q, errors)
                nxt = copy_in(item) if item is not None else None
            cur = nxt
        if pending is not None:
            if pending[0] is not None:
                pending[0].synchronize()
            out_q.put(pending[1:])
    finally:
        out_q.put(None)
        free_in.put(None)
        for t in threads:
            t.join()
    if errors:
        raise _Failed("a stream worker failed") from errors[0]
    stats = {"frames": frames, "chunks": chunks, "wall_s": time.perf_counter() - t0}
    if timeline:
        base = timeline[0][0]
        at = [[base.elapsed_time(e) for e in ev] for ev in timeline]
        copies = [(t[0], t[1]) for t in at] + [(t[4], t[5]) for t in at]
        kernels = [(t[2], t[3]) for t in at]
        stats.update({
            "h2d_ms": sum(t[1] - t[0] for t in at),
            "kernels_ms": sum(t[3] - t[2] for t in at),
            "d2h_ms": sum(t[5] - t[4] for t in at),
            "copies_under_kernels_ms": _interval_overlap(copies, kernels),
            "device_span_ms": at[-1][5],
        })
    return stats


def unit_frames(x: torch.Tensor) -> torch.Tensor:
    """u8 frames -> float32 in [0, 1], x / 255 correctly rounded on either
    device (a CPU-scalar divisor would be a multiply by its reciprocal on
    CUDA), as the JAX package's ``astype(float32) / 255``."""
    return x.float() / torch.tensor(255.0, device=x.device)


def to_u8(y: torch.Tensor) -> torch.Tensor:
    """[0, 1] float frames -> u8 as ``clip(y * 255 + 0.5, 0, 255).astype(uint8)``."""
    return (y.float() * 255.0 + 0.5).clamp_(0.0, 255.0).to(torch.uint8)


# -- video files ------------------------------------------------------------------

class _Cv2Reader:
    """cv2's reader with the native reader's interface (RGB u8, NHWC)."""

    def __init__(self, path: str):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cv2 cannot open {path}")
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 24
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def read(self, n: int, out: np.ndarray) -> np.ndarray:
        got = 0
        while got < n:
            ok, fr = self._cap.read()
            if not ok:
                break
            out[got] = fr[..., ::-1]
            got += 1
        return out[:got]

    def close(self) -> None:
        self._cap.release()


class _Cv2Writer:
    """cv2's writer with the native writer's interface (RGB u8, NHWC)."""

    def __init__(self, path: str, w: int, h: int, fps: float, codec: str):
        import cv2

        self._wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
        if not self._wr.isOpened():
            raise RuntimeError(f"cv2 cannot open a {codec} writer for {path}")

    def write(self, frames: np.ndarray) -> None:
        for fr in frames:
            self._wr.write(np.ascontiguousarray(fr[..., ::-1]))

    def close(self) -> None:
        self._wr.release()


def open_reader(path: str):
    """A frame reader (width, height, fps, read(n, out), close()): native, or
    cv2 where the native runtime did not load."""
    return native.VideoReader(path) if _backend() == "native" else _Cv2Reader(path)


def open_writer(path: str, w: int, h: int, fps: float, crf: int = 18, codec: str = "mp4v"):
    """An NHWC RGB u8 frame writer: native libx264 at `crf`, or cv2 with the
    fourcc `codec` where the native runtime did not load."""
    if _backend() == "native":
        return native.VideoWriter(path, w, h, codec="h264", crf=crf, fps=fps)
    return _Cv2Writer(path, w, h, fps, codec)


def embed_video_planar(model, input_path: str, output_path: str, chunk_size: int = 32,
                       crf: int = 18, lowres_attenuation: bool = True) -> dict:
    """Planar-u8 streaming embed: the native decoder fills planar buffers,
    one K1 launch blends each chunk, and the native encoder (libx264) reads
    the planar output. Needs `model.supports_planar` and the native runtime.
    lowres_attenuation (default True, the reference's video-serving
    setting) takes the JND at processing resolution."""
    if not model.supports_planar:
        raise ValueError("embed_video_planar needs a card with JND attenuation, additive "
                         "blending and a 1-channel prediction")
    reader = native.VideoReader(input_path)
    h, w, fps = reader.height, reader.width, reader.fps
    msgs = model.get_random_msg(1)
    try:
        with native.VideoWriter(output_path, w, h, codec="h264", crf=crf, fps=fps) as wr:
            stats = run_stream(
                lambda buf: reader.read_planar(buf.shape[0], out=buf).shape[0],
                planar_shape(chunk_size, h, w),
                lambda x: model.embed_planar(x, h, w, msgs=msgs,
                                             lowres_attenuation=lowres_attenuation)["imgs_w"],
                wr.write_planar, model.device)
    finally:
        reader.close()
    return {"msgs": msgs, "frames": stats["frames"], "fps": fps, "stats": stats}


def embed_video(model, input_path: str, output_path: str, chunk_size: int = 32,
                codec: str = "mp4v") -> dict:
    """Streaming embed of a video file: the planar path where the card
    supports it and the native runtime loaded, else NHWC frames through
    ``model.embed`` (`codec` is the cv2 fourcc where cv2 writes)."""
    if model.supports_planar and native.available():
        return embed_video_planar(model, input_path, output_path, chunk_size)
    reader = open_reader(input_path)
    h, w, fps = reader.height, reader.width, reader.fps
    msgs = model.get_random_msg(1)
    writer = open_writer(output_path, w, h, fps, codec=codec)
    try:
        stats = run_stream(lambda buf: reader.read(buf.shape[0], out=buf).shape[0],
                           (chunk_size, h, w, 3), embed_step(model, msgs), writer.write,
                           model.device)
    finally:
        reader.close()
        writer.close()
    return {"msgs": msgs, "frames": stats["frames"], "fps": fps, "stats": stats}


def embed_step(model, msgs):
    """The device work of the NHWC embed: u8 NHWC frames -> float / 255 ->
    ``model.embed`` as a video with `msgs` -> u8 frames, clip(x * 255 + 0.5)."""
    def step(x):
        return to_u8(model.embed(unit_frames(x), msgs=msgs, is_video=True)["imgs_w"])
    return step


def detect_step(model):
    """The device work of detection: u8 NHWC frames -> (n, 1 + nbits) f32
    logits, a pixelwise extractor's averaged over the pixels."""
    def step(x):
        preds = model.detect(unit_frames(x), is_video=True)["preds"]
        return (preds.mean(dim=(1, 2)) if preds.dim() == 4 else preds).float()
    return step


def detect_video(model, input_path: str, chunk_size: int = 32, aggregation: str = "avg",
                 return_preds: bool = False):
    """The video's message, (1, nbits) int32, from every frame's logits
    (with return_preds, also the (F, 1 + nbits) logits on the CPU)."""
    reader = open_reader(input_path)
    h, w = reader.height, reader.width
    preds: list = []
    try:
        run_stream(lambda buf: reader.read(buf.shape[0], out=buf).shape[0],
                   (chunk_size, h, w, 3), detect_step(model), lambda a: preds.append(a.copy()),
                   model.device)
    finally:
        reader.close()
    logits = torch.as_tensor(np.concatenate(preds))
    msg = aggregate_message(logits, aggregation)
    return (msg, logits) if return_preds else msg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="watermarked.mp4")
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--chunk_size", type=int, default=32)
    ap.add_argument("--detect", type=int, default=1)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .utils.cfg import load

    model = load(args.card, checkpoint=args.checkpoint, device=args.device)
    if args.dtype != "float32":
        model = model.with_dtype(args.dtype)
    info = embed_video(model, args.input, args.output, args.chunk_size)
    print(f"embedded {info['frames']} frames -> {args.output}")
    if args.detect:
        msg = detect_video(model, args.output, args.chunk_size)
        acc = float((info["msgs"][0].cpu() == msg[0].cpu()).float().mean())
        print(f"bit accuracy after {args.output.split('.')[-1]} round trip: {acc:.4f}")


if __name__ == "__main__":
    main()
