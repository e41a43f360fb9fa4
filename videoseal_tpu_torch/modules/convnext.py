"""ConvNeXtV2 extractor backbone, counterpart of ``videoseal_tpu/modules/convnext.py``.

Runs NHWC, the layout of the LN and pointwise work. The forward is
``kernels/convnext_fused.py::convnext_apply_fused``: every residual block
goes through K2 (``kernels/convnext_block.py``); the stem (4x4, stride 4)
and the 2x2 downsample convs are plain strided convolutions. Names follow the
reference state_dict (``downsample_layers``, ``stages``).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..kernels.convnext_block import convnext_block_fused, kernel_params
from ..kernels.convnext_fused import convnext_apply_fused
from .common import GRN, ChannelLayerNorm


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> pw(4x) -> GELU -> GRN -> pw -> residual, via K2."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = ChannelLayerNorm(dim, channels_last=True)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return convnext_block_fused(x, kernel_params(self))


class ConvNeXtV2(nn.Module):
    """4-stage ConvNeXtV2: (B, H, W, 3) -> (B, H/32, W/32, dims[-1]) for
    stem_stride 4."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), stem_stride: int = 4,
                 in_chans: int = 3, temporal_convs: bool = False,
                 temporal_attention: bool = False):
        super().__init__()
        if temporal_convs or temporal_attention:
            raise NotImplementedError("temporal ConvNeXt layers: ROADMAP.md 1.9")
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(in_chans, dims[0], 4, stride=stem_stride),
            ChannelLayerNorm(dims[0]))])
        for i in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                ChannelLayerNorm(dims[i - 1], channels_last=True),
                nn.Conv2d(dims[i - 1], dims[i], 2, stride=2)))
        self.stages = nn.ModuleList(
            nn.Sequential(*[ConvNeXtBlock(dims[i]) for _ in range(depths[i])])
            for i in range(4))

    def forward(self, x):
        return convnext_apply_fused(self, x)
