"""Color-space conversion (NHWC), counterpart of ``videoseal_tpu/ops/color.py``."""

from __future__ import annotations

import torch

_R2Y = (0.299, 0.587, 0.114)


def rgb_to_y(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (..., 1) luminance, as explicit multiply-adds."""
    y = _R2Y[0] * x[..., 0] + _R2Y[1] * x[..., 1] + _R2Y[2] * x[..., 2]
    return y[..., None]
