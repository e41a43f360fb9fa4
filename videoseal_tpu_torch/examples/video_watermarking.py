"""Video watermarking walkthrough, counterpart of
``examples/video_watermarking.py`` (and of ``notebooks/video_inference``):
embed one message into a clip, attack it with a real codec (H.264 at CRF
30 through the native runtime where it loads, else cv2's MPEG-4), extract
the message and write the watermarked clip.

  python -m videoseal_tpu_torch.examples.video_watermarking [--input in.mp4] \\
      [--card videoseal_1.0] [--frames 32] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None)
    ap.add_argument("--card", default="videoseal_1.0", help="a card name or a card file")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="outputs/example_video.mp4")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import native
    from ..evals.attacks import video_codec_exact
    from ..inference_streaming import open_reader, open_writer
    from ..ops import metrics
    from ..utils.cfg import load

    model = load(args.card, checkpoint=args.checkpoint, device=args.device)
    if args.input:
        r = open_reader(args.input)
        buf = np.empty((args.frames, r.height, r.width, 3), np.uint8)
        clip = r.read(args.frames, buf).astype(np.float32) / 255.0
        fps = int(round(r.fps)) or 24
        r.close()
    else:
        from ..evals.full import synthetic_samples
        clip = next(synthetic_samples(1, (args.frames, 360, 640, 3)))
        fps = 24
    x = torch.from_numpy(clip).to(model.device)

    out = model.embed(x, is_video=True)
    imgs_w, msgs = out["imgs_w"], out["msgs"][:1]
    psnr = float(metrics.psnr(imgs_w, x, is_video=True))
    print(f"embedded; PSNR {psnr:.2f} dB")

    w_np = imgs_w.float().cpu().numpy()
    codec, crf = ("h264", 30) if native.available() else ("mpeg4", None)
    attacked = video_codec_exact(w_np, codec, crf=crf)
    msg = model.extract_message(torch.from_numpy(attacked).to(model.device))
    acc = float((msg.cpu() == (msgs.cpu() > 0.5)).float().mean())
    print(f"bit accuracy after {codec}{f' crf{crf}' if crf else ''}: {acc:.4f}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    wr = open_writer(args.out, w_np.shape[2], w_np.shape[1], fps)
    try:
        wr.write(np.clip(w_np * 255.0 + 0.5, 0, 255).astype(np.uint8))
    finally:
        wr.close()
    print(f"wrote {args.out}")
    return {"psnr": psnr, "bit_acc": acc, "codec": codec, "frames": len(w_np)}


if __name__ == "__main__":
    main()
