"""ConvNeXtV2 extractor backbone, counterpart of ``videoseal_tpu/modules/convnext.py``.

Runs NHWC, the layout of the LN and pointwise work. Names follow the
reference state_dict (``downsample_layers``, ``stages``). Two routes, split by
`differentiable`:

* the kernel route (under ``torch.no_grad``, or when neither the input nor
  any parameter requires grad; every serving and eval entry point):
  ``kernels/convnext_fused.py::convnext_apply_fused``, every residual block
  through K2 (``kernels/convnext_block.py``), which rounds to bf16 inside as
  the TPU kernel does and builds no autograd graph;
* the differentiable route (grad enabled and something requires it; the
  training step): the linen module's own f32 math on the live parameters at
  the block's true width, as the JAX train step differentiates the linen
  extractor (``videoseal_tpu/parallel/trainer.py:159``), never a kernel.

The stem (4x4, stride 4) and the 2x2 downsample convs are plain strided
convolutions on both routes.

Temporal variants (``convnext_tiny_temporal``): `temporal_convs` follows the
downsample conv of stages 1-3 with a 3x1x1 convolution over the frames of
the batch (``downsample_layers.{i}.1`` is a ``Conv2p1dOp``: ``.conv`` and
``.temp_conv``), on both routes. `temporal_attention` puts a
``TemporalBlock`` (attention across frames) inside each block's residual,
after pwconv2; K2 fuses the residual, so such a block runs its module math
on both routes (no preset sets it).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.convnext_block import convnext_block_fused, kernel_params, padded_width
from ..kernels.convnext_fused import convnext_apply_fused
from .common import GRN, ChannelLayerNorm, Conv2p1dOp
from .vit import TemporalBlock


def differentiable(module: nn.Module, x: torch.Tensor) -> bool:
    """The route rule: grad is enabled and the input or a parameter of
    `module` requires it."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> pw(4x) -> GELU -> GRN -> pw [-> temp_block] ->
    residual. The kernel route runs K2 (at K2's padded width where dim is not
    a multiple of 16: x is padded and the result sliced here; the
    extractor's route pads once a stage); a block with `temp_block` takes
    its module math on both routes."""

    def __init__(self, dim: int, temporal_attention: bool = False):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = ChannelLayerNorm(dim, channels_last=True)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.temp_block = (TemporalBlock(dim, num_heads=dim // 48, use_rel_pos=True,
                                         video_len=32) if temporal_attention else None)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The linen block's math on the live parameters (NHWC, x's dtype)."""
        h = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = self.pwconv1(self.norm(h))
        h = self.pwconv2(self.grn(F.gelu(h)))
        if self.temp_block is not None:
            h = self.temp_block(h)
        return x + h

    def forward(self, x):
        if differentiable(self, x) or self.temp_block is not None:
            return self.forward_plain(x)
        c = x.shape[-1]
        if padded_width(c) == c:
            return convnext_block_fused(x, kernel_params(self))
        xp = F.pad(x, (0, padded_width(c) - c)).contiguous()
        return convnext_block_fused(xp, kernel_params(self))[..., :c]


class ConvNeXtV2(nn.Module):
    """4-stage ConvNeXtV2: (B, H, W, 3) -> (B, H/32, W/32, dims[-1]) for
    stem_stride 4."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), stem_stride: int = 4,
                 in_chans: int = 3, temporal_convs: bool = False,
                 temporal_attention: bool = False):
        super().__init__()
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv2d(in_chans, dims[0], 4, stride=stem_stride),
            ChannelLayerNorm(dims[0]))])
        for i in range(1, 4):
            conv = (Conv2p1dOp(dims[i - 1], dims[i], 2, stride=2, padding=0,
                               temporal_kernel_size=3) if temporal_convs
                    else nn.Conv2d(dims[i - 1], dims[i], 2, stride=2))
            self.downsample_layers.append(nn.Sequential(
                ChannelLayerNorm(dims[i - 1], channels_last=True), conv))
        self.stages = nn.ModuleList(
            nn.Sequential(*[ConvNeXtBlock(dims[i], temporal_attention)
                            for _ in range(depths[i])])
            for i in range(4))

    def forward(self, x):
        if not differentiable(self, x):
            return convnext_apply_fused(self, x)
        conv, norm = self.downsample_layers[0]
        x = norm(conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        for i, stage in enumerate(self.stages):
            if i > 0:
                norm, conv = self.downsample_layers[i]
                x = conv(norm(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            for blk in stage:
                x = blk.forward_plain(x)
        return x


# size presets
CONVNEXT_PRESETS = {
    "atto": dict(depths=(2, 2, 6, 2), dims=(40, 80, 160, 320)),
    "femto": dict(depths=(2, 2, 6, 2), dims=(48, 96, 192, 384)),
    "pico": dict(depths=(2, 2, 6, 2), dims=(64, 128, 256, 512)),
    "nano": dict(depths=(2, 2, 8, 2), dims=(80, 160, 320, 640)),
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "huge": dict(depths=(3, 3, 27, 3), dims=(352, 704, 1408, 2816)),
}
