"""Color-space conversion (NHWC), counterpart of ``videoseal_tpu/ops/color.py``:
the reference's analog YUV, as explicit multiply-adds on (..., 3) tensors."""

from __future__ import annotations

import torch

_R2Y = (0.299, 0.587, 0.114)
_R2U = (-0.14713, -0.28886, 0.436)
_R2V = (0.615, -0.51499, -0.10001)
_Y2R = (1.0, 0.0, 1.13983)
_Y2G = (1.0, -0.39465, -0.58060)
_Y2B = (1.0, 2.03211, 0.0)


def _mix(x: torch.Tensor, rows) -> torch.Tensor:
    c0, c1, c2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([r[0] * c0 + r[1] * c1 + r[2] * c2 for r in rows], dim=-1)


def rgb_to_yuv(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> YUV."""
    return _mix(x, (_R2Y, _R2U, _R2V))


def yuv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) YUV -> RGB."""
    return _mix(x, (_Y2R, _Y2G, _Y2B))


def rgb_to_y(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (..., 1) luminance, as explicit multiply-adds."""
    y = _R2Y[0] * x[..., 0] + _R2Y[1] * x[..., 1] + _R2Y[2] * x[..., 2]
    return y[..., None]
