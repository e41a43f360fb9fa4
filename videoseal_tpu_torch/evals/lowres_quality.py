"""The quality delta between the two planar serving JND placements.

Counterpart of ``videoseal_tpu/evals/lowres_quality.py``. Video serving
takes the JND attenuation at processing resolution
(``lowres_attenuation=True``); full-resolution JND is the image-mode
default. This harness records what the lowres placement costs: per mode the
PSNR, SSIM and L-inf against the original frames and the bit accuracy
through the extractor, then the mode-against-mode pixel delta.

  python -m videoseal_tpu_torch.evals.lowres_quality --height 1080 --width 1920

Output: one JSON line per mode plus a `delta` line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def run(card: str, height: int, width: int, frames: int, seed: int,
        device="cuda") -> list[dict]:
    from ..kernels.fused_planar import pack_planar, unpack_planar
    from ..ops.metrics import psnr, ssim
    from ..utils.cfg import load

    model = load(card, device=device)
    rng = np.random.default_rng(seed)
    # smooth-ish content: JND heatmaps on pure noise saturate, which would
    # understate the placement difference
    low = rng.uniform(0, 255, (frames, height // 8, width // 8, 3))
    imgs = np.clip(np.kron(low, np.ones((1, 8, 8, 1)))
                   + rng.normal(0, 6, (frames, height, width, 3)), 0, 255).astype(np.uint8)
    imgs_t = torch.as_tensor(imgs, device=model.device)
    imgs_p = pack_planar(imgs_t)
    msgs = model.get_random_msg(1)
    bits = msgs[0].cpu().numpy()
    x = imgs_t.float() / 255.0

    out, wm = [], {}
    for mode in (False, True):
        o = model.embed_planar(imgs_p, height, width, msgs=msgs, lowres_attenuation=mode)
        w = unpack_planar(o["imgs_w"], height, width)
        wm[mode] = w.cpu().numpy()
        y = w.float() / 255.0
        det = model.detect_planar(o["imgs_w"], height, width)["preds"].cpu().numpy()
        per_frame = ((det[:, 1:] > 0).astype(np.float32) == bits).mean()
        pooled = ((det[:, 1:].mean(0) > 0).astype(np.float32) == bits).mean()
        out.append({
            "mode": "lowres_attenuation" if mode else "fullres_jnd",
            "psnr": round(float(psnr(x, y).mean()), 3),
            "ssim": round(float(ssim(x, y).mean()), 5),
            "linf_u8": int(np.abs(wm[mode].astype(np.int16) - imgs.astype(np.int16)).max()),
            "bit_acc_per_frame": round(float(per_frame), 4),
            "bit_acc_pooled": round(float(pooled), 4),
        })
    d = np.abs(wm[True].astype(np.int16) - wm[False].astype(np.int16))
    out.append({"mode": "delta_lowres_vs_fullres",
                "max_u8": int(d.max()),
                "mean_u8": round(float(d.mean()), 4),
                "psnr_delta": round(out[1]["psnr"] - out[0]["psnr"], 3),
                "bit_acc_pooled_delta": round(out[1]["bit_acc_pooled"]
                                              - out[0]["bit_acc_pooled"], 4)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in run(args.card, args.height, args.width, args.frames, args.seed, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
