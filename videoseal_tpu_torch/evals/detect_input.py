"""The planar path's two detect inputs against each other on one model:
the extractor's input made inside the blend kernel (K1's detect output, a
bf16 downscale) against the separate planar resize of the watermarked
frames (float32), after the same lowres-attenuation embed.

    python -m videoseal_tpu_torch.evals.detect_input \\
        --checkpoint outputs/convergence_torch/stageA/checkpoint.npz

A train state (``train.py``'s checkpoint.npz) is loaded as
``tools/eval_checkpoint.py`` loads it, on the videoseal_1.0 card at 32 bits
and 128 px with scaling_w 1 (docs/training.md's stage A), and run in bf16,
the serving dtype; without --checkpoint the card runs at random init. The
frames are 64 1080p frames of smooth content with noise
(``evals/lowres_quality.py``'s kind) from seed 0, the message from seed 0
too. Output: one JSON line per detect input, then a `delta` line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

CARD, NBITS, IMG_SIZE = "videoseal_1.0", 32, 128      # docs/training.md's stage A
FRAMES, HEIGHT, WIDTH = 64, 1080, 1920


def smooth_frames(frames: int, height: int, width: int, seed: int) -> np.ndarray:
    """(frames, height, width, 3) u8: 8x8 blocks of uniform colour plus
    N(0, 6) noise, a frame at a time from `seed`."""
    rng = np.random.default_rng(seed)
    out = np.empty((frames, height, width, 3), np.uint8)
    for i in range(frames):
        low = rng.uniform(0, 255, (-(-height // 8), -(-width // 8), 3)).astype(np.float32)
        up = np.repeat(np.repeat(low, 8, 0), 8, 1)[:height, :width]
        noise = rng.normal(0, 6, (height, width, 3)).astype(np.float32)
        out[i] = np.clip(up + noise, 0, 255).astype(np.uint8)
    return out


def run(model, frames: np.ndarray) -> list[dict]:
    """Embed the frames once on the planar lowres path with each detect
    input, then score each input's logits against the message (seed 0)."""
    from ..kernels.fused_planar import pack_planar, unpack_planar
    from ..models.videoseal import aggregate_message
    from ..ops.metrics import psnr

    f, h, w, _ = frames.shape
    x = torch.as_tensor(frames, device=model.device)
    imgs_p = pack_planar(x)
    gen = torch.Generator().manual_seed(0)
    msgs = torch.randint(0, 2, (1, model.nbits), generator=gen).to(model.device)
    bits = msgs[0].cpu().numpy()
    rows, outs = [], {}
    for fused in (True, False):
        out = model.embed_detect_planar(imgs_p, h, w, msgs=msgs, lowres_attenuation=True,
                                        fused_detect=fused)
        preds = out["preds"].float().cpu()
        outs[fused] = (out["imgs_w"], preds)
        wm = unpack_planar(out["imgs_w"], h, w).float() / 255.0
        hard = (preds[:, 1:] > 0).numpy()
        rows.append({
            "detect_input": "fused (in the blend kernel, bf16)" if fused
                            else "separate (planar resize, f32)",
            "frames": f, "height": h, "width": w, "nbits": model.nbits,
            "img_size": model.cfg.img_size,
            "psnr": float(psnr(x.float() / 255.0, wm).mean()),
            "bit_acc_per_frame": float((hard == bits).mean()),
            "bit_acc_pooled": float((aggregate_message(preds)[0].numpy() == bits).mean()),
        })
    (wf, pf), (ws, ps) = outs[True], outs[False]
    rows.append({
        "detect_input": "delta_fused_vs_separate",
        "imgs_w_equal": bool(torch.equal(wf, ws)),
        "logits_max_abs_diff": float((pf - ps).abs().max()),
        "bits_flipped_share": float(((pf[:, 1:] > 0) != (ps[:, 1:] > 0)).float().mean()),
        "bit_acc_per_frame_delta": rows[0]["bit_acc_per_frame"] - rows[1]["bit_acc_per_frame"],
    })
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None, help="a train state .npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("detect_input runs on the CUDA device by default and none is "
                           "available; pass --device cpu to run it on the CPU")
    from ..tools.eval_checkpoint import load_trained_model

    model = load_trained_model(args.checkpoint, CARD, NBITS, IMG_SIZE, scaling_w=1.0,
                               device=args.device).with_dtype("bfloat16")
    rows = run(model, smooth_frames(FRAMES, HEIGHT, WIDTH, 0))
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
