"""DINOv2 ViT backbone of the ``dino2`` extractors, counterpart of
``videoseal_tpu/modules/dino.py``.

A pre-norm ViT with LayerScale, a cls token and a position table on a 37x37
grid, resized bicubically to the patch grid where the two differ. The patch
conv is VALID at stride 14, so a 256-px input gives 18x18 patches over 252
px. The output concatenates the hooked blocks' patch tokens after the final
``norm`` (hook indices taken mod depth). The attention is two matmuls around
a float32 softmax; every LayerNorm runs in float32 (eps 1e-6), GELU is the
erf form. Parameter names are DINOv2's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.norm1``, ``attn.qkv``, ``attn.proj``,
``ls1.gamma``, ``mlp.fc1``/``fc2``, ``ls2.gamma``, ``norm``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bicubic

DINO_PRESETS = {
    "dinov2_vits14": dict(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14": dict(embed_dim=768, depth=12, num_heads=12),
}


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-6) in float32, returned in x's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):   # (B, T, D)
        b, t, d = x.shape
        hd = d // self.num_heads
        q, k, v = self.qkv(x).reshape(b, t, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1)).float() * hd ** -0.5, dim=-1)
        y = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(b, t, d)
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoViT(nn.Module):
    """(B, H, W, 3) in [-1, 1] -> (B, H // 14, W // 14, len(hooks) * D)."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 14, mlp_ratio: float = 4.0, pos_grid: int = 37,
                 hook_indices: Sequence[int] = (8, 9, 10, 11)):
        super().__init__()
        self.patch_size, self.pos_grid = patch_size, pos_grid
        self.hook_indices = [int(i) % depth for i in hook_indices]
        self.patch_embed = _PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = LayerNorm(embed_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's position-table init, N(0, 0.02), from `generator`."""
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        b, h, w, _ = x.shape
        p, d = self.patch_size, self.pos_embed.shape[-1]
        gh, gw = h // p, w // p
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        pos = self.pos_embed.reshape(1, -1, d)
        grid = pos[:, 1:].reshape(1, self.pos_grid, self.pos_grid, d)
        x = x + resize_bicubic(grid, gh, gw).reshape(1, gh * gw, d).to(x.dtype)
        x = torch.cat([(self.cls_token + pos[:, :1]).to(x.dtype).expand(b, 1, d), x], dim=1)
        hooks = {}
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.hook_indices:
                hooks[i] = x
        feats = [self.norm(hooks[i])[:, 1:].reshape(b, gh, gw, d) for i in self.hook_indices]
        return torch.cat(feats, dim=-1)
