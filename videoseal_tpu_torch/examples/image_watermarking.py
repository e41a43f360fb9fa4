"""Image watermarking walkthrough, counterpart of
``examples/image_watermarking.py`` (and of ``notebooks/image_inference``):
embed a message, decode it clean and after a real JPEG round trip, and
write the original, the watermarked image and their difference.

  python -m videoseal_tpu_torch.examples.image_watermarking [--image path.png] \\
      [--card videoseal_1.0] [--checkpoint ckpt.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None)
    ap.add_argument("--card", default="videoseal_1.0", help="a card name or a card file")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out_dir", default="outputs/example")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..evals.attacks import jpeg_exact
    from ..ops import metrics
    from ..utils.cfg import load
    from ..utils.display import create_diff_img, save_img

    model = load(args.card, checkpoint=args.checkpoint, device=args.device)
    if args.image:
        import cv2
        img = cv2.imread(args.image, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(args.image)
        img = (img[..., ::-1].astype(np.float32) / 255.0)[None]
    else:
        from ..data.datasets import SyntheticImages
        img = SyntheticImages(1, img_size=512)[0][0][None]
    x = torch.from_numpy(np.ascontiguousarray(img)).to(model.device)

    out = model.embed(x, is_video=False)
    imgs_w, msgs = out["imgs_w"], out["msgs"]
    psnr = float(metrics.psnr(imgs_w, x)[0])
    print(f"embedded {model.nbits} bits; PSNR {psnr:.2f} dB")

    w_np = imgs_w.float().cpu().numpy()
    acc = {}
    for name, attacked in [("clean", w_np), ("jpeg50", jpeg_exact(w_np, 50))]:
        preds = model.detect(torch.from_numpy(attacked).to(model.device), is_video=False)["preds"]
        bits = preds[..., 1:] > 0
        acc[name] = float((bits == (msgs > 0.5)).float().mean())
        print(f"bit accuracy after {name}: {acc[name]:.4f}")

    os.makedirs(args.out_dir, exist_ok=True)
    save_img(img[0], os.path.join(args.out_dir, "original.png"))
    save_img(w_np[0], os.path.join(args.out_dir, "watermarked.png"))
    save_img(create_diff_img(img[0], w_np[0]), os.path.join(args.out_dir, "difference_x10.png"))
    print(f"wrote {args.out_dir}/{{original,watermarked,difference_x10}}.png")
    return {"psnr": psnr, "bit_acc": acc}


if __name__ == "__main__":
    main()
