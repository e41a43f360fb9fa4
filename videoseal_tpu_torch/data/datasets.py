"""Datasets, counterpart of ``SyntheticImages`` and ``ImageFolder`` in
``videoseal_tpu/data/datasets.py``. Items are (image, mask): NHWC float32
in [0, 1] as numpy, the mask (H, W, 1) all ones. Folders decode with cv2,
imported where it is used. The video clip and COCO-mask datasets are
ROADMAP.md 1.8.
"""

from __future__ import annotations

import json
import os

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _imread_rgb(path: str) -> np.ndarray:
    import cv2
    x = cv2.imread(path, cv2.IMREAD_COLOR)
    if x is None:
        raise IOError(f"cannot read {path}")
    return x[..., ::-1].astype(np.float32) / 255.0


def _resize_shorter(img: np.ndarray, size: int | None) -> np.ndarray:
    if size is None:
        return img
    import cv2
    h, w = img.shape[:2]
    s = size / min(h, w)
    return cv2.resize(img, (int(round(w * s)), int(round(h * s))),
                      interpolation=cv2.INTER_AREA)


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top:top + size, left:left + size]


class ImageFolder:
    """A recursive image folder, its sorted path list cached as JSON in
    ``<path>/.cache/paths.json``; each image resized (shorter side) and
    center-cropped to img_size."""

    def __init__(self, path: str, img_size: int = 256, use_cache: bool = True):
        self.path = path
        self.img_size = img_size
        cache = os.path.join(path, ".cache", "paths.json")
        if use_cache and os.path.exists(cache):
            with open(cache) as f:
                self.samples = json.load(f)
        else:
            self.samples = sorted(
                os.path.join(r, f)
                for r, _, files in os.walk(path) for f in files
                if f.lower().endswith(IMG_EXTS))
            if use_cache:
                try:
                    os.makedirs(os.path.dirname(cache), exist_ok=True)
                    with open(cache, "w") as f:
                        json.dump(self.samples, f)
                except OSError:
                    pass    # a read-only dataset: the index is rebuilt each run

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = _imread_rgb(self.samples[idx])
        img = _center_crop(_resize_shorter(img, self.img_size), self.img_size)
        mask = np.ones(img.shape[:2] + (1,), np.float32)
        return img, mask


class SyntheticImages:
    """Procedural photo-like images (gradients, waves, blocky texture), the
    JAX package's bit for bit: item i is drawn from seed * 100003 + i."""

    def __init__(self, n: int = 1000, img_size: int = 256, seed: int = 0):
        self.n = n
        self.size = img_size
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h = w = self.size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([yy / h, xx / w, (xx + yy) / (h + w)], -1)
        img = img * rng.uniform(0.4, 1.0, (1, 1, 3))
        img += 0.15 * np.sin(xx[..., None] / rng.uniform(2, 19) + rng.uniform(0, 7))
        tex = rng.normal(0, 0.1, (h // 16, w // 16, 3)).astype(np.float32)
        img += np.repeat(np.repeat(tex, 16, 0), 16, 1)
        img = np.clip(img, 0, 1).astype(np.float32)
        mask = np.ones((h, w, 1), np.float32)
        return img, mask
