"""Shared neural blocks, counterpart of ``videoseal_tpu/modules/common.py``.

Convolutional blocks run NCHW (PyTorch's convolution layout); the ConvNeXt
path runs NHWC. Parameter names and shapes follow the reference PyTorch
modules, so a reference state_dict loads directly:

* ``ChannelLayerNorm``: LayerNorm over the channel axis (eps 1e-6),
  ``weight``/``bias`` of shape (C,);
* ``GRN``: ``gamma``/``beta`` of shape (1, 1, 1, C), 1e-12 floor under the
  square root;
* ``make_norm``: "batch" is ``nn.BatchNorm2d`` (eps 1e-5), used in eval
  mode; "group" ``nn.GroupNorm`` (8 groups, eps 1e-5); "layer" a
  ``ChannelLayerNorm``; "rms" ``ChanRMSNorm``, ``gamma`` of shape (C, 1, 1);
* GELU is the exact erf form (``nn.GELU()``); SiLU and LeakyReLU (slope 0.2)
  complete the activation registry.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_bilinear


def get_activation(name: str) -> nn.Module:
    if name == "relu":
        return nn.ReLU()
    if name == "leakyrelu":
        return nn.LeakyReLU(0.2)
    if name == "gelu":
        return nn.GELU()
    if name == "silu":
        return nn.SiLU()
    raise NotImplementedError(f"activation {name!r}")


def channel_ln(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dim: int, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over axis `dim` (eps 1e-6, as every ConvNeXt/UNet LN of the
    model), computed in float32, returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=dim, keepdim=True)
    var = (xf - mu).square().mean(dim=dim, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[dim] = -1
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis only. `channels_last` selects NHWC
    (axis -1) or NCHW (axis 1)."""

    def __init__(self, dim: int, channels_last: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.channels_last = channels_last

    def forward(self, x):
        return channel_ln(x, self.weight, self.bias, -1 if self.channels_last else 1)


class GRN(nn.Module):
    """Global Response Normalization over (H, W) of NHWC input."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        xf = x.float()
        gx = torch.sqrt(torch.clamp(xf.square().sum(dim=(-3, -2), keepdim=True),
                                    min=1e-12))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma.float() * (xf * nx) + self.beta.float() + xf).to(x.dtype)


class ChanRMSNorm(nn.Module):
    """RMS norm over the channel axis of NCHW input: F.normalize over C
    times sqrt(C) times gamma, with the JAX package's floors (1e-24 under the
    square root, 1e-12 on the norm), in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim, 1, 1))

    def forward(self, x):
        norm = torch.sqrt(torch.clamp(x.square().sum(dim=1, keepdim=True), min=1e-24))
        return x / torch.clamp(norm, min=1e-12) * self.scale * self.gamma


def make_norm(kind: str, dim: int) -> nn.Module:
    """The reference's norm registry, on NCHW input."""
    if kind.startswith("batch"):
        return nn.BatchNorm2d(dim, eps=1e-5)
    if kind.startswith("group"):
        return nn.GroupNorm(8, dim, eps=1e-5)
    if kind.startswith("layer"):
        return ChannelLayerNorm(dim)
    if kind.startswith("rms"):
        return ChanRMSNorm(dim)
    raise NotImplementedError(f"normalization {kind!r}")


class Interpolate(nn.Module):
    """Bilinear x`factor` resample of NCHW input with the JAX package's
    matrices (no antialias). f32 input resamples in f32, anything else in
    bf16, as ``videoseal_tpu.modules.common.Upsample`` does."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        if self.factor == 1:
            return x
        h, w = x.shape[-2] * self.factor, x.shape[-1] * self.factor
        prec = "highest" if x.dtype == torch.float32 else "default"
        y = resize_bilinear(x.permute(0, 2, 3, 1), h, w, antialias=False,
                            precision=prec, out_dtype=x.dtype)
        return y.permute(0, 3, 1, 2)


class Upsample(nn.Module):
    """Bilinear upscale block on NCHW: resample -> reflect pad -> 3x3 conv
    -> channel LN -> act. `upsample_block` indices follow the reference."""

    def __init__(self, upscale_type: str, in_channels: int, out_channels: int,
                 up_factor: int, activation: str):
        super().__init__()
        if upscale_type != "bilinear":
            raise NotImplementedError(
                f"upscale_type {upscale_type!r}: ported with the other cards "
                "(ROADMAP.md 1.2)")
        self.upsample_block = nn.Sequential(
            Interpolate(up_factor),
            nn.ReflectionPad2d(1),
            nn.Conv2d(in_channels, out_channels, 3, bias=False),
            ChannelLayerNorm(out_channels),
            get_activation(activation),
        )

    def forward(self, x):
        return self.upsample_block(x)

