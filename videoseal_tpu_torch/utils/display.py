"""Snapshot images via cv2, counterpart of ``save_img`` and ``create_diff_img`` in
``videoseal_tpu/utils/display.py``."""

from __future__ import annotations

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_img(img: np.ndarray, path: str) -> None:
    """(H, W, 3) [0,1] RGB -> an image file."""
    import cv2
    cv2.imwrite(path, _to_u8(img)[..., ::-1])


def create_diff_img(a: np.ndarray, b: np.ndarray, gain: float = 10.0) -> np.ndarray:
    """|a - b| amplified by `gain`, clipped to [0, 1]."""
    return np.clip(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                   * gain, 0, 1)
