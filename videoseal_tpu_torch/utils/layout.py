"""Layout helpers, counterpart of ``videoseal_tpu/utils/layout.py``: the
reference is NCHW, the port's API NHWC. Each takes a numpy array or a torch
tensor and returns the same kind."""

from __future__ import annotations

import numpy as np
import torch


def nchw_to_nhwc(x):
    """(..., C, H, W) -> (..., H, W, C)."""
    return x.movedim(-3, -1) if isinstance(x, torch.Tensor) else np.moveaxis(np.asarray(x), -3, -1)


def nhwc_to_nchw(x):
    """(..., H, W, C) -> (..., C, H, W)."""
    return x.movedim(-1, -3) if isinstance(x, torch.Tensor) else np.moveaxis(np.asarray(x), -1, -3)
