"""PixelDecoder head, counterpart of ``videoseal_tpu/modules/pixel_decoder.py``:
Upsample stages, then either a global mean pool and Linear(1 + nbits)
(one message per image) or, pixelwise, a 1x1 conv to 1 + nbits channels
(a detection mask and a message map per pixel, PixelSeal-style
localisation). Both heads are named ``linear``, as the reference names them."""

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
        ups, dim = [], embed_dim
        for f in upscale_stages:
            ups.append(Upsample(upscale_type, dim, dim // f, f, "gelu"))
            dim //= f
        self.output_upscaling = nn.Sequential(*ups)
        self.linear = nn.Conv2d(dim, nbits + 1, 1) if pixelwise else nn.Linear(dim, nbits + 1)
        self.pixelwise = pixelwise
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, h, w, C) NHWC features -> (B, 1 + nbits), or pixelwise
        (B, h * prod(upscale_stages), w * prod(...), 1 + nbits)."""
        x = self.output_upscaling(x.permute(0, 3, 1, 2))
        if self.pixelwise:
            preds = self.linear(x).permute(0, 2, 3, 1)
        else:
            preds = self.linear(x.mean(dim=(-2, -1)))
        return torch.sigmoid(preds) if self.sigmoid_output else preds
