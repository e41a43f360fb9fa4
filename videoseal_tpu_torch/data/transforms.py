"""Train-time data transforms, counterpart of
``videoseal_tpu/data/transforms.py``: the resize and crop pipelines and the
colour-jitter train augmentation, host-side numpy per sample."""

from __future__ import annotations

import numpy as np


def get_resize_transform(img_size: int, resize_only: bool = False):
    """Resize-shorter(+center-crop) pipeline."""
    from .datasets import _resize_shorter, _center_crop

    def fn(img: np.ndarray) -> np.ndarray:
        img = _resize_shorter(img, img_size)
        if not resize_only:
            img = _center_crop(img, img_size)
        return img

    return fn


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.1) -> np.ndarray:
    """Random color jitter, numpy host-side."""
    out = img.astype(np.float32)
    if brightness > 0:
        f = rng.uniform(1 - brightness, 1 + brightness)
        out = np.clip(out * f, 0, 1)
    if contrast > 0:
        f = rng.uniform(1 - contrast, 1 + contrast)
        gray = (0.299 * out[..., 0] + 0.587 * out[..., 1]
                + 0.114 * out[..., 2]).mean()
        out = np.clip(f * out + (1 - f) * gray, 0, 1)
    if saturation > 0:
        f = rng.uniform(1 - saturation, 1 + saturation)
        gray = (0.299 * out[..., 0] + 0.587 * out[..., 1]
                + 0.114 * out[..., 2])[..., None]
        out = np.clip(f * out + (1 - f) * gray, 0, 1)
    if hue > 0:
        import cv2
        shift = rng.uniform(-hue, hue) * 180.0  # cv2 hue is [0,180)
        hsv = cv2.cvtColor((out * 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift)) % 180
        out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255
    return out


def get_transforms(img_size: int, brightness=0.2, contrast=0.2,
                   saturation=0.2, hue=0.1, seed: int = 0):
    """Train/val transform pair."""
    rng = np.random.default_rng(seed)
    resize = get_resize_transform(img_size)

    def train(img):
        return color_jitter(resize(img), rng, brightness, contrast,
                            saturation, hue)

    return train, resize
