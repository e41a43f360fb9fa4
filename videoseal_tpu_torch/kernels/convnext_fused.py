"""ConvNeXtV2 forward over the port's parameters with every residual block
through K2, or groups of blocks through K3. Counterpart of
``videoseal_tpu/kernels/convnext_fused.py::convnext_apply_fused``; the TPU's
VMEM gating (``supports_block``, ``frames_per_step`` and the VMEM test of
``blocks_per_step``) has no counterpart: on a CUDA tensor every group is a
K2 or K3 launch, on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from .convnext_block import block_params, convnext_block_fused, convnext_blocks_fused


def block_groups(depth: int, max_block_group: int = 1) -> list[int]:
    """The sizes of the block groups of a stage of `depth` blocks: the JAX
    package's grouping without its VMEM test. kmax is the largest power of
    two <= min(4, depth), capped at max_block_group; each group takes
    min(kmax, blocks left)."""
    if max_block_group < 1:
        raise ValueError(f"max_block_group must be >= 1, got {max_block_group}")
    kmax = 1
    while kmax * 2 <= min(4, depth):
        kmax *= 2
    kmax = min(kmax, max_block_group)
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
    x = norm(conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1).contiguous()
    for i, stage in enumerate(encoder.stages):
        if i > 0:
            norm, conv = encoder.downsample_layers[i]
            x = conv(norm(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
        j = 0
        for k in block_groups(len(stage), max_block_group):
            if k == 1:
                x = convnext_block_fused(x, block_params(stage[j]))
            else:
                x = convnext_blocks_fused(x, [block_params(stage[jj]) for jj in range(j, j + k)])
            j += k
    return x
