"""Render every validation augmentation at each of its strengths to PNG
files for eyeballing, counterpart of ``videoseal_tpu/augmentation/doaugs.py``:
``<out_dir>/<Aug>_<strength>.png``, the first frame of the attacked batch
(one image, or 8 copies of it as a clip with --is_video 1), written with
cv2. An attack that cannot run at the sample's size is reported and left
out.

  python -m videoseal_tpu_torch.augmentation.doaugs [--image path] [--out_dir dir]
      [--device cpu]

The attacks run on the CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None)
    ap.add_argument("--out_dir", default="outputs/augs")
    ap.add_argument("--is_video", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("doaugs runs on the CUDA device by default and none is available; "
                           "pass --device cpu to run it on the CPU")

    from ..utils.display import save_img
    from .validation import get_validation_augs

    if args.image:
        import cv2
        img = cv2.imread(args.image, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(args.image)
        img = img[..., ::-1].astype(np.float32) / 255.0
    else:
        from ..data.datasets import SyntheticImages
        img = SyntheticImages(1, img_size=256)[0][0]
    n = 8 if args.is_video else 1
    batch = torch.as_tensor(np.repeat(img[None], n, axis=0), device=args.device)
    mask = torch.ones(batch.shape[:-1] + (1,), device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for aug, strengths in get_validation_augs(bool(args.is_video)):
        for s in strengths:
            try:
                out, _ = aug.apply_strength(batch, mask, s)
            except ValueError as e:     # an attack the sample's size refuses
                print(f"skip {aug!r}@{s}: {e}")
                continue
            path = os.path.join(args.out_dir, f"{repr(aug).split('(')[0]}_{s}.png")
            save_img(out[0].detach().cpu().numpy(), path)
            written.append(path)
            print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
