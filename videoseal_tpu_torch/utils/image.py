"""Image utilities, counterpart of ``videoseal_tpu/utils/image.py``: each is
the port's own implementation under the reference's name."""

from __future__ import annotations

import numpy as np
import torch


def jpeg_compress(img: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg round trip of (..., H, W, 3) RGB in [0, 1] (cv2)."""
    from ..evals.attacks import jpeg_exact
    return jpeg_exact(img, quality)


def webp_compress(img: np.ndarray, quality: int) -> np.ndarray:
    """WebP round trip of (..., H, W, 3) RGB in [0, 1] (cv2)."""
    from ..evals.attacks import webp_exact
    return webp_exact(img, quality)


def median_filter(img, kernel_size: int = 3) -> torch.Tensor:
    """Window median of (..., H, W, C) with a reflect pad (a tensor or an
    array; the result a tensor on its device)."""
    from ..augmentation.augs import MedianFilter
    return MedianFilter(passthrough=False)._median(torch.as_tensor(img), kernel_size)


def create_diff_img(a, b, gain: float = 10.0) -> np.ndarray:
    """|a - b| amplified by `gain`, clipped to [0, 1]."""
    from .display import create_diff_img as _create_diff_img
    return _create_diff_img(a, b, gain)
