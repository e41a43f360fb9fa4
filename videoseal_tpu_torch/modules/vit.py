"""SAM/ViTDet-style image encoder, counterpart of ``videoseal_tpu/modules/vit.py``.

The extractor of videoseal_0.0 (``sam_small``): a 16x16 patch embedding, an
absolute position embedding, transformer blocks with windowed attention
(zero-padded windows) or global attention at the given depths, both with the
decomposed relative position bias, and a neck of a 1x1 conv, a channel LN,
a 3x3 conv and a channel LN. NHWC throughout, as the reference.

No TPU kernel lies on this path: the JAX package computes attention as plain
einsums. Here it is two matmuls around a softmax; the softmax, its bias sums
and every LayerNorm run in float32 and round to the model's dtype after.
Parameter names follow the reference state dict (``patch_embed.proj``,
``pos_embed``, ``blocks.{i}.norm1/norm2``, ``attn.qkv``, ``attn.proj``,
``attn.rel_pos_h/_w``, ``mlp.lin1/lin2``, ``neck.0..3``). The temporal
variant (temporal attention blocks, ``pos_embed_temporal``) is on no card:
ROADMAP.md 1.9.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.resize import _resize_matrix
from .common import ChannelLayerNorm


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The (q_size, k_size, C) relative embeddings of rel_pos (L, C); a table
    of another length than 2 * max(q_size, k_size) - 1 is resampled linearly
    first (the antialiased resize matrix, as the JAX package)."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        m = torch.as_tensor(_resize_matrix(rel_pos.shape[0], max_rel_dist, antialias=True),
                            device=rel_pos.device)
        rel_pos = (m @ rel_pos.float()).to(rel_pos.dtype)
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = ((q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)).astype(np.int64)
    return rel_pos[torch.as_tensor(rel, device=rel_pos.device)]


class Attention(nn.Module):
    """Multi-head attention with the decomposed rel-pos bias over (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 use_rel_pos: bool = False, input_size: tuple[int, int] | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            hd = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, dim = x.shape
        nh = self.num_heads
        hd = dim // nh
        q, k, v = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = ((q * hd ** -0.5) @ k.transpose(-2, -1)).float()   # (b, nh, hw, hw)
        if self.use_rel_pos:
            rq = q.reshape(b, nh, h, w, hd)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, get_rel_pos(h, h, self.rel_pos_h))
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, get_rel_pos(w, w, self.rel_pos_w))
            attn = (attn.view(b, nh, h, w, h, w) + rel_h.float()[..., :, None]
                    + rel_w.float()[..., None, :]).view(b, nh, h * w, h * w)
        out = torch.softmax(attn, dim=-1).to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(b, h, w, dim))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = nn.GELU()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


def window_partition(x: torch.Tensor, window_size: int):
    """(B, H, W, C) -> (B * nw, ws, ws, C) windows, the frame zero-padded at
    its bottom and right to a multiple of the window, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph = (window_size - h % window_size) % window_size
    pw = (window_size - w % window_size) % window_size
    if ph or pw:
        x = nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // window_size, window_size, wp // window_size, window_size, c)
    return x.transpose(2, 3).reshape(-1, window_size, window_size, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw: tuple[int, int],
                       hw: tuple[int, int]) -> torch.Tensor:
    """The inverse of `window_partition`, the padding cut off -> (B, H, W, C)."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size, window_size, -1)
    return x.transpose(2, 3).reshape(b, hp, wp, -1)[:, :h, :w]


class Block(nn.Module):
    """Transformer block; window_size > 0 attends within windows, 0 over the
    whole grid of input_size."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 use_rel_pos: bool = False, window_size: int = 0,
                 input_size: tuple[int, int] | None = None):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim, channels_last=True)
        size = input_size if window_size == 0 else (window_size, window_size)
        self.attn = Attention(dim, num_heads, qkv_bias, use_rel_pos, size)
        self.norm2 = ChannelLayerNorm(dim, channels_last=True)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    """(B, img_size, img_size, in_chans) NHWC -> (B, g, g, out_chans),
    g = img_size // patch_size."""

    def __init__(self, img_size: int = 256, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, out_chans: int = 256, qkv_bias: bool = True,
                 use_abs_pos: bool = True, use_rel_pos: bool = False, window_size: int = 0,
                 global_attn_indexes: Sequence[int] = (), temporal_attention: bool = False,
                 max_temporal_length: int = 32):
        super().__init__()
        if temporal_attention:
            raise NotImplementedError("temporal ViT attention: ROADMAP.md 1.9")
        grid = img_size // patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = (nn.Parameter(torch.zeros(1, grid, grid, embed_dim)) if use_abs_pos
                          else None)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, use_rel_pos,
                  0 if i in tuple(global_attn_indexes) else window_size, (grid, grid))
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False), ChannelLayerNorm(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            ChannelLayerNorm(out_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.pos_embed is not None:
            x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
