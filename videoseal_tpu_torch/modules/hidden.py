"""HiDDeN encoder and decoder, counterpart of ``videoseal_tpu/modules/hidden.py``.

The classic watermarking baseline: stacks of 3x3 conv -> norm -> act. The
encoder tiles the (+-1) message over the image and concatenates
[message, features, image] before a last conv block and a 1x1 conv; the
decoder's conv blocks end in a global mean pool and a Linear(1 + nbits), or
pixelwise in a 1x1 conv to 1 + nbits channels. NCHW inside, NHWC in and
out, as the JAX modules. Norms come from ``common.make_norm`` (BatchNorm's
running variance updated with the biased variance, as flax does).

Names: ``conv_bns.{i}``, ``after_concat_layer``, ``final_layer`` and
``layers.{i}``, ``linear``; a block's conv and norm are ``.layers.0`` and
``.layers.1``.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import get_activation, make_norm


class ConvBNRelu(nn.Module):
    """3x3 conv (with bias) -> norm -> act on NCHW."""

    def __init__(self, in_channels: int, out_channels: int, activation: str,
                 normalization: str):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1),
            make_norm(normalization, out_channels), get_activation(activation))

    def forward(self, x):
        return self.layers(x)


class HiddenEncoder(nn.Module):
    """(B, H, W, in_channels) images in [-1, 1] and (B, num_bits) messages
    already mapped to +-1 -> (B, H, W, out_channels)."""

    def __init__(self, num_blocks: int, num_bits: int, in_channels: int = 3,
                 out_channels: int = 3, z_channels: int = 64, activation: str = "gelu",
                 normalization: str = "layer", last_tanh: bool = True):
        super().__init__()
        kw = dict(activation=activation, normalization=normalization)
        self.conv_bns = nn.Sequential(*[
            ConvBNRelu(in_channels if i == 0 else z_channels, z_channels, **kw)
            for i in range(num_blocks)])
        self.after_concat_layer = ConvBNRelu(num_bits + z_channels + in_channels,
                                             z_channels, **kw)
        self.final_layer = nn.Conv2d(z_channels, out_channels, 1)
        self.last_tanh = last_tanh

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        x = imgs.permute(0, 3, 1, 2)
        b, _, h, w = x.shape
        m = msgs.to(x.dtype)[:, :, None, None].expand(b, msgs.shape[-1], h, w)
        y = self.after_concat_layer(torch.cat([m, self.conv_bns(x), x], dim=1))
        y = self.final_layer(y)
        return (torch.tanh(y) if self.last_tanh else y).permute(0, 2, 3, 1)


class HiddenDecoder(nn.Module):
    """(B, H, W, in_channels) images in [-1, 1] -> (B, 1 + num_bits), or
    pixelwise (B, H, W, 1 + num_bits)."""

    def __init__(self, num_blocks: int, num_bits: int, in_channels: int = 3,
                 z_channels: int = 64, activation: str = "gelu",
                 normalization: str = "layer", pixelwise: bool = False):
        super().__init__()
        self.layers = nn.Sequential(*[
            ConvBNRelu(in_channels if i == 0 else z_channels, z_channels, activation,
                       normalization)
            for i in range(num_blocks + 1)])
        self.linear = (nn.Conv2d(z_channels, num_bits + 1, 1) if pixelwise
                       else nn.Linear(z_channels, num_bits + 1))
        self.pixelwise = pixelwise

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        x = self.layers(imgs.permute(0, 3, 1, 2))
        if self.pixelwise:
            return self.linear(x).permute(0, 2, 3, 1)
        return self.linear(x.mean(dim=(-2, -1)))
