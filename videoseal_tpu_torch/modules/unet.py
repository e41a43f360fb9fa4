"""UNetMsg, the watermark embedder, counterpart of ``videoseal_tpu/modules/unet.py``.

NCHW throughout. inc ResnetBlock -> DBlocks (stride-2 3x3 conv + ResnetBlock)
-> message concat at the bottleneck -> num_blocks ResnetBlocks -> UBlocks
(2x bilinear Upsample + ResnetBlock) with skip concats scaled by 2**-0.5 ->
1x1 conv -> tanh. Submodule names follow the reference state_dict.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .common import Upsample, get_activation, make_norm
from .msg_processor import MsgProcessor


class ResnetBlock(nn.Module):
    """2 x (conv3x3 - norm - act) + 1x1 residual conv."""

    def __init__(self, in_channels: int, out_channels: int, activation: str,
                 normalization: str):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            make_norm(normalization, out_channels),
            get_activation(activation),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            make_norm(normalization, out_channels),
            get_activation(activation),
        )
        self.res_conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        return self.double_conv(x) + self.res_conv(x)


class DBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, activation: str,
                 normalization: str):
        super().__init__()
        self.down = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=1)
        self.conv = ResnetBlock(out_channels, out_channels, activation, normalization)

    def forward(self, x):
        return self.conv(self.down(x))


class UBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, activation: str,
                 normalization: str):
        super().__init__()
        self.up = Upsample("bilinear", in_channels, out_channels, 2, activation)
        self.conv = ResnetBlock(out_channels, out_channels, activation, normalization)

    def forward(self, x):
        return self.conv(self.up(x))


class Bottleneck(nn.Module):
    def __init__(self, channels: int, num_blocks: int, activation: str,
                 normalization: str):
        super().__init__()
        self.model = nn.Sequential(*[
            ResnetBlock(channels, channels, activation, normalization)
            for _ in range(num_blocks)])

    def forward(self, x):
        return self.model(x)


class UNetMsg(nn.Module):
    """Message-conditioned UNet; input NCHW in [-1, 1]."""

    def __init__(self, nbits: int, hidden_size: int, in_channels: int = 3,
                 out_channels: int = 3, z_channels: int = 16, num_blocks: int = 8,
                 activation: str = "relu", normalization: str = "batch",
                 z_channels_mults: Sequence[int] = (1, 2, 4, 8),
                 upsampling_type: str = "bilinear",
                 downsampling_type: str = "bilinear", last_tanh: bool = True,
                 msg_processor_type: str = "binary+concat",
                 conv_layer: str = "conv2d"):
        super().__init__()
        if (upsampling_type, downsampling_type, conv_layer) != (
                "bilinear", "bilinear", "conv2d"):
            raise NotImplementedError(
                "only bilinear up/downsampling with conv2d layers is ported "
                "(ROADMAP.md 1.2 and 1.9)")
        zc = [z_channels * m for m in z_channels_mults]
        kw = dict(activation=activation, normalization=normalization)
        self.inc = ResnetBlock(in_channels, zc[0], **kw)
        self.downs = nn.ModuleList(
            DBlock(zc[i], zc[i + 1], **kw) for i in range(len(zc) - 1))
        self.msg_processor = MsgProcessor(nbits, hidden_size, msg_processor_type)
        bott = zc[-1] + hidden_size
        self.bottleneck = Bottleneck(bott, num_blocks, **kw)
        ups = []
        for i, ii in enumerate(reversed(range(len(zc) - 1))):
            in_c = 2 * bott if i == 0 else 2 * zc[ii + 1]
            ups.append(UBlock(in_c, zc[ii], **kw))
        self.ups = nn.ModuleList(ups)
        self.outc = nn.Conv2d(zc[0], out_channels, 1)
        self.last_tanh = last_tanh

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        x = self.inc(imgs)
        hiddens = [x]
        for down in self.downs:
            hiddens.append(down(hiddens[-1]))
        x = self.msg_processor(hiddens.pop(), msgs)
        hiddens.append(x)
        x = self.bottleneck(x)
        scale = 2 ** -0.5
        for up in self.ups:
            x = up(torch.cat([x, hiddens.pop() * scale], dim=1))
        logits = self.outc(x)
        return torch.tanh(logits) if self.last_tanh else logits
