"""Taming-transformers VAE encoder and decoder, counterpart of
``videoseal_tpu/modules/vae.py`` (the ``vae*`` embedders).

NCHW, with the reference's state-dict names (``conv_in``,
``down.{level}.block.{i}.norm1``, ``down.{level}.attn.{i}``,
``down.{level}.downsample.conv``, ``mid.block_1``, ``mid.attn_1``,
``up.{level}.upsample.conv``, ``norm_out``, ``conv_out``). GroupNorm has 16
groups and eps 1e-6, computed in float32; the nonlinearity is swish. The
downsample is a zero pad of one row and one column at the bottom and right,
then a VALID stride-2 3x3 conv; the decoder upsamples by nearest repetition.
The attention is single-head over the H*W positions, in float32 (the JAX
module's ``precision="highest"``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.GroupNorm):
    """GroupNorm(16, eps 1e-6) in float32, returned in x's dtype."""

    def __init__(self, channels: int):
        super().__init__(16, channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = _conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = _conv3x3(out_channels, out_channels)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial positions, scale c^-0.5."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(channels, channels, 1)
                                                 for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).reshape(b, c, h * w).float() for m in (self.q, self.k, self.v))
        att = torch.softmax((q.transpose(1, 2) @ k) * c ** -0.5, dim=-1)   # (b, hw, hw)
        out = (v @ att.transpose(1, 2)).reshape(b, c, h, w).to(x.dtype)
        return x + self.proj_out(out)


class _Level(nn.Module):
    """One resolution level: ``block`` and ``attn`` lists, and a resampling
    ``downsample`` or ``upsample`` where the level has one."""

    def __init__(self, blocks: list, attn: list):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attn)

    def run(self, h):
        for i, blk in enumerate(self.block):
            h = blk(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h


class _Resample(nn.Module):
    """Downsample: pad (0, 1, 0, 1), stride-2 VALID conv; upsample: nearest
    2x, then a 3x3 conv."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = (nn.Conv2d(channels, channels, 3, stride=2) if down
                     else _conv3x3(channels, channels))

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1))


class _Mid(nn.Module):
    def __init__(self, channels: int, attn: bool):
        super().__init__()
        self.block_1 = VAEResnetBlock(channels, channels)
        self.attn_1 = AttnBlock(channels) if attn else None
        self.block_2 = VAEResnetBlock(channels, channels)

    def forward(self, h):
        h = self.block_1(h)
        if self.attn_1 is not None:
            h = self.attn_1(h)
        return self.block_2(h)


class VAEEncoder(nn.Module):
    """(B, in_channels, H, W) -> (B, 2 * z_channels (double_z) or
    z_channels, H / 2^(levels-1), ...). `resolution` is the nominal size that
    places the attention (`attn_resolutions`); `out_ch` is unused, as in the
    JAX module."""

    def __init__(self, ch: int, out_ch: int, num_res_blocks: int, in_channels: int = 3,
                 resolution: int = 256, z_channels: int = 4,
                 ch_mult: Sequence[int] = (1, 2, 4, 8),
                 attn_resolutions: Sequence[int] = (), double_z: bool = True):
        super().__init__()
        self.conv_in = _conv3x3(in_channels, ch)
        curr_res, block_in = resolution, ch
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            block_out = ch * mult
            blocks = [VAEResnetBlock(block_in if i == 0 else block_out, block_out)
                      for i in range(num_res_blocks)]
            attn = ([AttnBlock(block_out) for _ in range(num_res_blocks)]
                    if curr_res in attn_resolutions else [])
            level = _Level(blocks, attn)
            block_in = block_out
            if i_level != len(ch_mult) - 1:
                level.downsample = _Resample(block_in, down=True)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, curr_res in attn_resolutions)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = _conv3x3(block_in, 2 * z_channels if double_z else z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = level.run(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VAEDecoder(nn.Module):
    """(B, z_channels, h, w) -> (B, 3, h * 2^(levels-1), ...): `z_channels`
    is conv_in's input width. `bw` computes one channel and tiles it to
    three; `tanh_out` ends with tanh."""

    def __init__(self, ch: int, out_ch: int, num_res_blocks: int, resolution: int = 256,
                 z_channels: int = 4, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 attn_resolutions: Sequence[int] = (), tanh_out: bool = False,
                 bw: bool = False):
        super().__init__()
        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = _conv3x3(z_channels, block_in)
        self.mid = _Mid(block_in, curr_res in attn_resolutions)
        levels = [None] * num_res
        for i_level in reversed(range(num_res)):
            block_out = ch * ch_mult[i_level]
            blocks = [VAEResnetBlock(block_in if i == 0 else block_out, block_out)
                      for i in range(num_res_blocks + 1)]
            attn = ([AttnBlock(block_out) for _ in range(num_res_blocks + 1)]
                    if curr_res in attn_resolutions else [])
            level = _Level(blocks, attn)
            block_in = block_out
            if i_level != 0:
                level.upsample = _Resample(block_in, down=False)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = _conv3x3(block_in, 1 if bw else out_ch)
        self.tanh_out = tanh_out
        self.bw = bw

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level.run(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        if self.tanh_out:
            h = torch.tanh(h)
        return h.expand(-1, 3, -1, -1) if self.bw else h
