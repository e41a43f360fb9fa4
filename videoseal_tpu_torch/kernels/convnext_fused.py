"""ConvNeXtV2 forward over the port's parameters with every residual block
through K2. Counterpart of ``videoseal_tpu/kernels/convnext_fused.py::
convnext_apply_fused``; the TPU's VMEM gating (``supports_block``,
``frames_per_step``) has no counterpart: on a CUDA tensor every block is a
K2 launch, on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from .convnext_block import block_params, convnext_block_fused


def convnext_apply_fused(encoder, x: torch.Tensor) -> torch.Tensor:
    """encoder: a ``modules.convnext.ConvNeXtV2``; x (B, H, W, 3) NHWC in
    [-1, 1] -> (B, H/32, W/32, dims[-1]) for stem_stride 4. The stem and the
    2x2 downsample convs are plain strided convolutions on NCHW."""
    conv, norm = encoder.downsample_layers[0]
    x = norm(conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1).contiguous()
    for i, stage in enumerate(encoder.stages):
        if i > 0:
            norm, conv = encoder.downsample_layers[i]
            x = conv(norm(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
        for blk in stage:
            x = convnext_block_fused(x, block_params(blk))
    return x
