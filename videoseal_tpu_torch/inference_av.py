"""Video+audio watermarking, counterpart of ``videoseal_tpu/inference_av.py``.

Watermarks the video stream on the card and, with --audio_wm 1, the audio
track too (spread spectrum, ``audio_wm.py``); otherwise the original audio
is stream-copied by the native remuxer. The reference watermarks audio with
AudioSeal (its inference_av.py:83-108); the `audio_processor` hook takes any
replacement (``audio_wm.make_audio_processor`` is the built-in one).

Routes, as in the JAX package: with the native media runtime, the clip's
frames are embedded in chunks (float frames, one message for the clip),
encoded with libx264 and remuxed with the (processed) audio; without it,
``inference_streaming.embed_video`` writes the video alone (cv2) and the
audio is dropped. The returned dict names the route and the audio outcome.

  python -m videoseal_tpu_torch.inference_av --input in.mp4 --output out.mp4 \\
      [--audio_wm 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from . import native


def embed_av(model, input_path: str, output_path: str, chunk_size: int = 32,
             codec: str = "h264", crf: int = 18, audio_processor=None) -> dict:
    """Watermark `input_path` into `output_path`: {"msgs", "frames", "route"
    ("native" or "cv2"), "audio" (an audio stream was written),
    "audio_wm" (the track written is the processor's, not the input's),
    "audio_note" (why not, where either is False)}."""
    from .inference_streaming import embed_video, to_u8, unit_frames

    if not native.available():
        info = embed_video(model, input_path, output_path, chunk_size)
        return {"msgs": info["msgs"], "frames": info["frames"], "route": "cv2", "audio": False,
                "audio_wm": False,
                "audio_note": f"no native muxer ({native.last_error()}): video only"}

    fd, tmp_video = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    audio_src = input_path
    try:
        # 1) watermark the video stream, chunk by chunk on the device
        reader = native.VideoReader(input_path)
        fps = int(round(reader.fps)) or 24
        msgs = model.get_random_msg(1)
        frames_out = []
        try:
            while True:
                chunk = reader.read(chunk_size)
                if chunk.shape[0] == 0:
                    break
                x = unit_frames(torch.from_numpy(chunk).to(model.device))
                out = model.embed(x, msgs=msgs, is_video=True)
                frames_out.append(to_u8(out["imgs_w"]).cpu().numpy())
        finally:
            reader.close()
        all_frames = (np.concatenate(frames_out) if frames_out
                      else np.zeros((0, reader.height, reader.width, 3), np.uint8))
        native.encode_file(tmp_video, all_frames, codec=codec, crf=crf, fps=fps)
        # 2) remux the original audio, or the processor's
        if audio_processor is not None:
            audio_src = audio_processor(input_path)
        wm = audio_src != input_path
        note = None
        if audio_processor is not None and not wm:
            note = "the audio processor returned the input (no ffmpeg, or no audio): copied"
        try:
            had_audio = native.mux_audio(tmp_video, audio_src, output_path)
        except RuntimeError as e:
            os.replace(tmp_video, output_path)       # the mux failed: keep the video
            return {"msgs": msgs, "frames": len(all_frames), "route": "native",
                    "audio": False, "audio_wm": False, "audio_note": str(e)}
        if not had_audio:
            note = "the input has no audio stream"
        return {"msgs": msgs, "frames": len(all_frames), "route": "native",
                "audio": bool(had_audio), "audio_wm": bool(had_audio and wm),
                "audio_note": note}
    finally:
        if os.path.exists(tmp_video):
            os.remove(tmp_video)
        if audio_src != input_path and os.path.exists(audio_src):
            os.remove(audio_src)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default="watermarked_av.mp4")
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--crf", type=int, default=18)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--audio_wm", type=int, default=0,
                    help="watermark the audio track too (spread spectrum, audio_wm.py; the "
                         "reference uses AudioSeal here)")
    ap.add_argument("--audio_nbits", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .utils.cfg import load

    model = load(args.card, checkpoint=args.checkpoint, device=args.device)
    if args.dtype != "float32":
        model = model.with_dtype(args.dtype)
    audio_processor = None
    if args.audio_wm:
        from .audio_wm import SpreadSpectrumAudio, make_audio_processor
        wm = SpreadSpectrumAudio(nbits=args.audio_nbits, device=args.device)
        audio_msg = wm.get_random_msg(torch.Generator().manual_seed(0))
        audio_processor = make_audio_processor(audio_msg, wm)
        print(f"audio msg: {''.join(map(str, audio_msg.tolist()))}")
    info = embed_av(model, args.input, args.output, crf=args.crf,
                    audio_processor=audio_processor)
    audio = ("watermarked" if info["audio_wm"] else "copied") if info["audio"] else "none"
    print(f"embedded {info['frames']} frames -> {args.output} ({info['route']} route, "
          f"audio={audio}{'; ' + info['audio_note'] if info['audio_note'] else ''})")
    return info


if __name__ == "__main__":
    main()
