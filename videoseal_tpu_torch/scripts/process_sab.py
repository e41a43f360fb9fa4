"""Prepare an SA-1B-style image directory for training, counterpart of
``videoseal_tpu/scripts/process_sab.py``.

Splits a flat image directory deterministically into test (the first
`num_test` files, sorted), val (the next `num_val`) and train (the rest),
with the same shards and flags as the JAX package. Test and val files are
byte copies. Train files are read with cv2 (as stored: no EXIF rotation,
grey stays grey, as PIL opens them), resized to `size` x `size` on the
device with Pillow's default resize (``ops/resize.resize_bicubic_pil``,
bit for bit), batched over the files of one shape, and written with cv2
(JPEG at quality 75, Pillow's default). A fourth channel is resized as it
is, where Pillow would premultiply it.

  python -m videoseal_tpu_torch.scripts.process_sab SRC DST [--size 256] \\
      [--num_test 1000] [--num_val 1000] [--num_shards 1] [--shard 0] \\
      [--workers 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

EXTS = (".jpg", ".jpeg", ".png")
BATCH = 32          # train files read, resized and written together


def list_images(src: str) -> list[str]:
    return sorted(f for f in os.listdir(src) if f.lower().endswith(EXTS))


def split_files(files: list[str], num_test: int, num_val: int):
    """(test, val, train): the leading files become the held-out splits,
    copied unresized; the rest trains at low resolution."""
    return (files[:num_test], files[num_test:num_test + num_val],
            files[num_test + num_val:])


def _read(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cv2 cannot read {path}")
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: {img.dtype} pixels; 8-bit images only")
    return img if img.ndim == 3 else img[..., None]


def _write(path: str, img: np.ndarray) -> None:
    import cv2
    params = ([cv2.IMWRITE_JPEG_QUALITY, 75]
              if path.lower().endswith((".jpg", ".jpeg")) else [])
    if not cv2.imwrite(path, img, params):
        raise IOError(f"cv2 cannot write {path}")


def resize_files(pairs: list[tuple[str, str]], size: int, device, pool=None) -> None:
    """Each (src, dst) image resized to size x size: read, stacked by
    shape, resized on `device` in one call a shape, written."""
    from ..ops.resize import resize_bicubic_pil
    pairs = [(s, d) for s, d in pairs if not os.path.exists(d)]
    run = pool.map if pool is not None else map
    imgs = list(run(_read, [s for s, _ in pairs]))
    groups: dict[tuple, list[int]] = {}
    for i, img in enumerate(imgs):
        groups.setdefault(img.shape, []).append(i)
    out: list = [None] * len(pairs)
    for idx in groups.values():
        x = torch.from_numpy(np.stack([imgs[i] for i in idx])).to(device)
        y = resize_bicubic_pil(x, size, size).cpu().numpy()
        for i, img in zip(idx, y):
            out[i] = img
    list(run(lambda a: _write(a[0][1], a[1]), zip(pairs, out)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--size", type=int, default=256,
                    help="train-split resize (test/val keep full res)")
    ap.add_argument("--num_test", type=int, default=1000)
    ap.add_argument("--num_val", type=int, default=1000)
    ap.add_argument("--num_shards", type=int, default=1)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--workers", type=int, default=0,
                    help="threads reading and writing files; 0 = in the main thread")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("process_sab resizes on the CUDA device by default and none is "
                           "available; pass --device cpu to resize on the CPU")

    files = list_images(args.src)
    test, val, train = split_files(files, args.num_test, args.num_val)
    for split in ("train", "test", "val"):
        os.makedirs(os.path.join(args.dst, split), exist_ok=True)
    jobs = ([(f, "test") for f in test] + [(f, "val") for f in val]
            + [(f, "train") for f in train])
    jobs = jobs[args.shard::args.num_shards]
    paths = [(os.path.join(args.src, f), os.path.join(args.dst, split, f), split)
             for f, split in jobs]

    pool = ThreadPoolExecutor(args.workers) if args.workers > 0 else None
    try:
        for s, d, split in paths:
            if split != "train" and not os.path.exists(d):
                shutil.copyfile(s, d)
        train_pairs = [(s, d) for s, d, split in paths if split == "train"]
        for i in range(0, len(train_pairs), BATCH):
            resize_files(train_pairs[i:i + BATCH], args.size, device, pool)
    finally:
        if pool is not None:
            pool.shutdown()
    print(f"shard {args.shard}/{args.num_shards}: {len(jobs)} files "
          f"(splits: {len(test)} test / {len(val)} val / {len(train)} train)")
    return {"files": len(jobs), "train": len(train_pairs)}


if __name__ == "__main__":
    main()
