"""Lane-packed 3x3 convs, counterpart of ``videoseal_tpu/kernels/lane_pack.py``.

An exact repack of a small-width conv: a 3x3 stride-1 SAME conv producing
C_out channels equals a 4x4 stride-2 VALID conv (on the 1-padded input)
producing 4*C_out channels, one channel group per output-pixel phase (a, b)
of the 2x2 cell, followed by depth-to-space:

    out[2i+a, 2j+b, co] = sum_{dy,dx,ci} W3[co,ci,dy,dx] * x[2i+a+dy-1, 2j+b+dx-1, ci]

The tap row a+dy-1 spans -1..2: a 4x4 window anchored at (2i, 2j) on the
padded input. Packing W3 into W4[(a,b,co), ci, a+dy, b+dx] makes the
equality exact (the 7 other taps of each phase are zeros), at 16/9 of the
MACs and four times the output width. The JAX package keeps it as an option
of ``unet_apply_fused``, off by default (measured neutral on its
accelerator); the port's ``unet_apply_fused(..., lane_pack=True)`` takes it
the same way. This is no kernel: the conv is ``F.conv2d`` (cuDNN on the
card) on a channels_last view of the NHWC input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# phases in (row, col) order, matching the depth-to-space below
_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def pack_weight(w3: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, Ci, 3, 3) -> (4*Co, Ci, 4, 4); output block a*2+b holds
    phase (a, b)'s copy of W3 at spatial offset (a, b)."""
    return torch.cat([F.pad(w3, (b, 1 - b, a, 1 - a)) for a, b in _PHASES], dim=0)


def conv3x3_lane_packed(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor | None = None,
                        *, prepadded: bool = False) -> torch.Tensor:
    """An exact 3x3 stride-1 SAME (zero-pad) conv via 4x4/s2 + depth-to-space.

    x: NHWC (N, H, W, Ci) with H, W even, or with prepadded=True
    (N, H+2, W+2, Ci), already padded by 1 on each side (in any mode: the
    Upsample block's reflect pad, say). w3: OIHW."""
    if not prepadded:
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
    co = w3.shape[0]
    w4 = pack_weight(w3).to(x.dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w4, stride=2).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + torch.cat([bias] * 4).to(x.dtype)
    n, h2, w2, _ = y.shape
    y = y.reshape(n, h2, w2, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h2 * 2, w2 * 2, co)


def supports_lane_pack(x_shape, w_shape) -> bool:
    """The JAX package's rule: a 3x3 kernel, 4*Co <= 128, even spatial dims
    of at least 64. `x_shape` NHWC, `w_shape` OIHW."""
    h, w = x_shape[-3], x_shape[-2]
    return (w_shape[2] == 3 and w_shape[3] == 3 and w_shape[0] * 4 <= 128
            and h % 2 == 0 and w % 2 == 0 and h >= 64 and w >= 64)
