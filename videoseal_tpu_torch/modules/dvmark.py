"""DVMark's 3D-conv video watermarking encoder and decoder, counterpart of
``videoseal_tpu/modules/dvmark.py``.

The frames of the batch (F, H, W, C) are one video of length F: the convs are
3D (NCDHW) with ``k // 2`` zero padding, so each output frame mixes its
neighbours (`mixes_frames`: the pipeline pads a short last chunk with frame
0, as the JAX package's ``lax.map`` does). The spatial pools are VALID (1, 2,
2) windows, flooring odd sizes. Parameter names are the JAX module's
(``transform.{i}``, ``emb1.{i}``, ``emb2.{i}``, ``emb3.{i}``, ``layer1``..``layer4``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear


def _conv3d(cin: int, cout: int, k=(3, 3, 3)) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, padding=tuple(ki // 2 for ki in k))


def _pool(x):
    """VALID (1, 2, 2) average pool of NCDHW (odd sizes floor), in x's dtype
    (the CPU's avg_pool3d takes no bfloat16)."""
    n, c, f, h, w = x.shape
    x = x[..., :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, c, f, h // 2, 2, w // 2, 2).mean(dim=(4, 6))


def _msg_planes(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(F, nbits) messages -> (1, nbits, F, h, w), constant over space."""
    return m.t()[None, :, :, None, None].expand(1, m.shape[1], m.shape[0], h, w)


class DVMarkEncoder(nn.Module):
    """(F, H, W, in_channels) in [-1, 1] and (F or 1, nbits) messages ->
    (F, H, W, 3) in [-1, 1]: the message tiled at full and half size."""
    mixes_frames = True

    def __init__(self, num_bits: int, in_channels: int = 3):
        super().__init__()
        self.num_bits = num_bits
        self.transform = nn.ModuleList(
            _conv3d(in_channels if i == 0 else 64, 64, (1, 3, 3) if i < 3 else (3, 3, 3))
            for i in range(4))
        self.emb1 = nn.ModuleList([_conv3d(64 + num_bits, 256), _conv3d(256, 128),
                                   _conv3d(128, 128)])
        self.emb2 = nn.ModuleList([_conv3d(128 + num_bits, 512), _conv3d(512, 256),
                                   _conv3d(256, 256)])
        self.emb3 = nn.ModuleList([_conv3d(128 + 256, 256), _conv3d(256, 128),
                                   _conv3d(128, 3)])

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        f, h, w, _ = imgs.shape
        x = imgs.permute(3, 0, 1, 2)[None]
        for conv in self.transform:
            x = F.relu(conv(x))
        m = msgs.to(x.dtype)
        if m.shape[0] != f:   # one message for the video
            m = m[:1].expand(f, self.num_bits)
        x = torch.cat([x, _msg_planes(m, h, w)], dim=1)
        for conv in self.emb1:
            x = F.relu(conv(x))
        skip = x
        x = torch.cat([_pool(skip), _msg_planes(m, h // 2, w // 2)], dim=1)
        for conv in self.emb2:
            x = F.relu(conv(x))
        x = resize_bilinear(x[0].permute(1, 2, 3, 0), h, w, antialias=False)
        x = torch.cat([skip, x.permute(3, 0, 1, 2)[None]], dim=1)
        for i, conv in enumerate(self.emb3):
            x = conv(x)
            if i < 2:
                x = F.relu(x)
        return torch.tanh(x)[0].permute(1, 2, 3, 0)


class DVMarkDecoder(nn.Module):
    """(F, H, W, 3) -> (F, 1 + nbits) float32: four 3D convs with two
    spatial pools, then the mean over space."""
    mixes_frames = True

    def __init__(self, num_bits: int):
        super().__init__()
        self.layer1 = _conv3d(3, 128)
        self.layer2 = _conv3d(128, 128)
        self.layer3 = _conv3d(128, 256)
        self.layer4 = _conv3d(256, num_bits + 1)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        x = imgs.permute(3, 0, 1, 2)[None]
        x = F.relu(self.layer2(F.relu(self.layer1(x))))
        x = F.relu(self.layer3(_pool(x)))
        x = self.layer4(_pool(x))
        return x.float().mean(dim=(3, 4))[0].t()
