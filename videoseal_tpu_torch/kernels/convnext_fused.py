"""ConvNeXtV2 forward over the port's parameters with every residual block
through K2, or groups of blocks through K3. Counterpart of
``videoseal_tpu/kernels/convnext_fused.py::convnext_apply_fused``; the TPU's
VMEM gating (``supports_block``, ``frames_per_step`` and the VMEM test of
``blocks_per_step``) has no counterpart: on a CUDA tensor every group is a
K2 or K3 launch, on a CPU tensor its plain version. A stage whose width is
not a multiple of 16 (chunkyseal's) runs at K2's padded width: the
activation is padded with zero channels once after the stem or downsample
conv and sliced back once at the stage's end (``convnext_block.py`` says why
the pads stay zero).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .convnext_block import (convnext_block_fused, convnext_blocks_fused, k3_takes,
                             kernel_params, padded_width)


def block_groups(depth: int, max_block_group: int = 1, shape: tuple | None = None) -> list[int]:
    """The sizes of the block groups of a stage of `depth` blocks: the JAX
    package's grouping without its VMEM test. kmax is the largest power of
    two <= min(4, depth), capped at max_block_group; each group takes
    min(kmax, blocks left). A stage whose (H, W, C) `shape` K3 does not take
    runs in groups of one (K2 launches), as the JAX package sizes each stage's
    groups by what its kernel takes, down to single blocks."""
    if max_block_group < 1:
        raise ValueError(f"max_block_group must be >= 1, got {max_block_group}")
    kmax = 1
    while kmax * 2 <= min(4, depth):
        kmax *= 2
    kmax = min(kmax, max_block_group)
    if shape is not None and not k3_takes(*shape):
        kmax = 1
    groups = []
    while sum(groups) < depth:
        groups.append(min(kmax, depth - sum(groups)))
    return groups


def convnext_apply_fused(encoder, x: torch.Tensor, max_block_group: int = 1) -> torch.Tensor:
    """encoder: a ``modules.convnext.ConvNeXtV2``; x (B, H, W, 3) NHWC in
    [-1, 1] -> (B, H/32, W/32, dims[-1]) for stem_stride 4. The stem and the
    2x2 downsample convs are plain strided convolutions on NCHW. Each stage's
    blocks run in the groups of `block_groups`: a group of one is a K2
    launch, a larger group one K3 launch."""
    conv, norm = encoder.downsample_layers[0]
    x = norm(conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    for i, stage in enumerate(encoder.stages):
        if i > 0:
            norm, conv = encoder.downsample_layers[i]
            x = conv(norm(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        c, cp = x.shape[-1], padded_width(x.shape[-1])
        x = (F.pad(x, (0, cp - c)) if cp != c else x).contiguous()
        j = 0
        for k in block_groups(len(stage), max_block_group, (*x.shape[1:3], c)):
            if k == 1:
                x = convnext_block_fused(x, kernel_params(stage[j]))
            else:
                x = convnext_blocks_fused(x, [kernel_params(stage[jj]) for jj in range(j, j + k)])
            j += k
        x = x[..., :c]
    return x
