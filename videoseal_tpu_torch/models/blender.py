"""Watermark blending, counterpart of ``videoseal_tpu/models/blender.py``.

Plain torch over NHWC tensors; `scaling_i` and `scaling_w` are scalars.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

AVAILABLE_BLENDING_METHODS = ["additive", "multiplicative", "spatial_smoothed", "variance_based"]


def blend(method: str, imgs: torch.Tensor, preds_w: torch.Tensor, scaling_i, scaling_w
          ) -> torch.Tensor:
    if method == "additive":
        return scaling_i * imgs + scaling_w * preds_w
    if method == "multiplicative":
        return scaling_i * imgs * (1 + scaling_w * preds_w)
    if method == "spatial_smoothed":
        # zero-padded 5x5 box sum of the sigmoid over (H, W), divided by 25
        att = torch.sigmoid(preds_w)
        shape = att.shape
        a = att.reshape((-1,) + tuple(shape[-3:])).permute(0, 3, 1, 2)
        a = F.avg_pool2d(a, 5, stride=1, padding=2, count_include_pad=True)
        att = a.permute(0, 2, 3, 1).reshape(shape)
        return scaling_i * imgs * (1 - att) + scaling_w * att * torch.sigmoid(preds_w)
    if method == "variance_based":
        var = torch.var(preds_w, dim=(-3, -2, -1), keepdim=True, correction=0)
        strength = torch.sigmoid(var * scaling_w)
        return scaling_i * imgs * (1 - strength) + strength * preds_w
    raise ValueError(f"Unknown blending method: {method}")
