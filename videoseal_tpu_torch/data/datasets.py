"""Datasets, counterpart of ``videoseal_tpu/data/datasets.py``. Items are
(image or clip, mask): float32 in [0, 1] as numpy, HWC (a clip FHWC), the
mask (H, W, 1). Files decode with cv2, imported where it is used.

* ImageFolder: a recursive image folder, its path list cached;
* CocoMasksDataset: COCO annotations -> (image, the union of its objects'
  masks), decoded by ``utils/rle.py``;
* VideoClipDataset: clips of frames_per_clip frames from a folder of
  videos, cv2 capture handles kept in an LRU cache;
* SyntheticImages: procedural images;
* iter_samples: batches of a folder for the evals.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
VID_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


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


class LRUDict(OrderedDict):
    """A thread-safe LRU map: `get_or(key, factory)` returns the cached
    value or makes it, dropping (and releasing, where it has `release`) the
    least recently used beyond maxsize."""

    def __init__(self, maxsize: int = 16):
        super().__init__()
        self.maxsize = maxsize
        self._lock = threading.RLock()

    def get_or(self, key, factory):
        with self._lock:
            if key in self:
                self.move_to_end(key)
                return self[key]
            val = factory()
            self[key] = val
            if len(self) > self.maxsize:
                _, old = self.popitem(last=False)
                close = getattr(old, "release", None)
                if close:
                    close()
            return val


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


class CocoMasksDataset:
    """COCO detection annotations -> (image, mask): the union of the
    image's objects' segmentations (at most max_objects, chosen at random),
    resized (shorter side) and center-cropped with the image, the mask by
    nearest neighbour. Images without annotations are left out."""

    def __init__(self, img_dir: str, ann_file: str, img_size: int = 256,
                 max_objects: int | None = None, multi: bool = False, seed: int = 0):
        with open(ann_file) as f:
            coco = json.load(f)
        self.img_dir = img_dir
        self.img_size = img_size
        self.max_objects = max_objects
        self.multi = multi
        self.rng = np.random.default_rng(seed)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_img: dict[int, list] = {}
        for ann in coco.get("annotations", []):
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.ids = [i for i in self.images if i in self.anns_by_img]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        import cv2

        from ..utils.rle import segmentation_to_mask
        info = self.images[self.ids[idx]]
        img = _imread_rgb(os.path.join(self.img_dir, info["file_name"]))
        h, w = img.shape[:2]
        anns = self.anns_by_img[self.ids[idx]]
        if self.max_objects and len(anns) > self.max_objects:
            sel = self.rng.choice(len(anns), self.max_objects, replace=False)
            anns = [anns[i] for i in sel]
        mask = np.zeros((h, w), np.uint8)
        for ann in anns:
            mask |= segmentation_to_mask(ann["segmentation"], h, w)
        s = self.img_size
        img = _center_crop(_resize_shorter(img, s), s)
        scale = s / min(h, w)
        m = cv2.resize(mask.astype(np.float32), (int(round(w * scale)), int(round(h * scale))),
                       interpolation=cv2.INTER_NEAREST)
        return img, _center_crop(m[..., None], s).astype(np.float32)


class VideoClipDataset:
    """Clips of a folder of videos: item i is clip i % num_clips of video
    i // num_clips, each video split into num_clips equal parts and the
    clip starting at a random frame of its part; frames_per_clip frames,
    every frame_step-th, resized (shorter side) and center-cropped. A
    video that cannot give a whole clip is skipped for the next one (up to
    8 tries). cv2 capture handles stay open in an LRU cache."""

    def __init__(self, path: str, frames_per_clip: int = 16, frame_step: int = 1,
                 img_size: int = 256, num_clips: int = 2, seed: int = 0,
                 max_open: int = 16):
        self.paths = sorted(os.path.join(r, f) for r, _, files in os.walk(path)
                            for f in files if f.lower().endswith(VID_EXTS))
        self.fpc = frames_per_clip
        self.step = frame_step
        self.img_size = img_size
        self.num_clips = num_clips
        self.rng = np.random.default_rng(seed)
        self._meta: dict[str, int] = {}
        self._caps = LRUDict(max_open)

    def __len__(self):
        return len(self.paths) * self.num_clips

    def _capture(self, path):
        import cv2
        return self._caps.get_or(path, lambda: cv2.VideoCapture(path))

    def _frame_count(self, path) -> int:
        import cv2
        if path not in self._meta:
            self._meta[path] = int(self._capture(path).get(cv2.CAP_PROP_FRAME_COUNT))
        return self._meta[path]

    def _read_clip(self, path, start):
        import cv2
        with self._caps._lock:
            cap = self._capture(path)
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
            frames = []
            for _ in range(self.fpc):
                for _ in range(self.step):
                    ret, fr = cap.read()
                if not ret:
                    break
                frames.append(_center_crop(_resize_shorter(
                    fr[..., ::-1].astype(np.float32) / 255.0, self.img_size), self.img_size))
        return np.stack(frames) if len(frames) == self.fpc else None

    def __getitem__(self, idx):
        import cv2
        for attempt in range(8):
            path = self.paths[(idx // self.num_clips + attempt) % len(self.paths)]
            ci = idx % self.num_clips
            try:
                total = self._frame_count(path)
                span = self.fpc * self.step
                part = max(total // self.num_clips, span)
                lo = ci * part
                hi = max(lo, min(lo + part - span, total - span))
                clip = self._read_clip(path, int(self.rng.integers(lo, hi + 1)))
            except (OSError, ValueError, cv2.error):     # a corrupt file: the next video
                clip = None
            if clip is not None:
                return clip, np.ones(clip.shape[1:3] + (1,), np.float32)
        raise IOError(f"no readable video clips around index {idx}")


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


def iter_samples(path: str, is_video: bool = False, img_size: int = 256, batch: int = 4):
    """The evals' samples from a folder: clips of 16 frames, one at a
    time, or images in batches of `batch`."""
    if is_video:
        ds = VideoClipDataset(path, frames_per_clip=16, img_size=img_size)
        for i in range(len(ds)):
            yield ds[i][0]
    else:
        ds = ImageFolder(path, img_size=img_size)
        for i in range(0, len(ds), batch):
            yield np.stack([ds[j][0] for j in range(i, min(i + batch, len(ds)))])
