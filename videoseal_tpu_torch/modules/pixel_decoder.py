"""PixelDecoder head, counterpart of ``videoseal_tpu/modules/pixel_decoder.py``:
bilinear Upsample stages, then a global mean pool and Linear(1 + nbits)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .common import Upsample


class PixelDecoder(nn.Module):
    def __init__(self, embed_dim: int, nbits: int = 0,
                 upscale_stages: Sequence[int] = (4, 2, 2),
                 upscale_type: str = "bilinear", sigmoid_output: bool = False,
                 pixelwise: bool = False):
        super().__init__()
        if pixelwise:
            raise NotImplementedError("pixelwise decoder: ROADMAP.md 1.9")
        ups, dim = [], embed_dim
        for f in upscale_stages:
            ups.append(Upsample(upscale_type, dim, dim // f, f, "gelu"))
            dim //= f
        self.output_upscaling = nn.Sequential(*ups)
        self.linear = nn.Linear(dim, nbits + 1)
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, h, w, C) NHWC features -> (B, 1 + nbits)."""
        x = self.output_upscaling(x.permute(0, 3, 1, 2))
        preds = self.linear(x.mean(dim=(-2, -1)))
        return torch.sigmoid(preds) if self.sigmoid_output else preds
