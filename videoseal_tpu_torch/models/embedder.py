"""Embedder wrapper and builder, counterpart of ``videoseal_tpu/models/embedder.py``.

An embedder maps ([0,1] NHWC images, (B, nbits) messages) to a watermark
prediction in [-1, 1], NHWC; the x*2-1 preprocess lives inside.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..modules.hidden import HiddenEncoder
from ..modules.unet import UNetMsg


class UnetEmbedder(nn.Module):
    def __init__(self, nbits: int, hidden_size: int, unet: dict):
        super().__init__()
        self.unet = UNetMsg(nbits=nbits, hidden_size=hidden_size, **unet)

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        x = (imgs * 2 - 1).permute(0, 3, 1, 2)
        return self.unet(x, msgs).permute(0, 2, 3, 1)


class HiddenEmbedder(nn.Module):
    """The HiDDeN encoder; messages mapped to +-1 inside. Built from the
    preset's own keys (``HiddenEncoder``'s: num_blocks, in_channels,
    out_channels, z_channels, normalization, activation, last_tanh), as the
    reference's registry builds it."""

    def __init__(self, nbits: int, **encoder):
        super().__init__()
        self.hidden_encoder = HiddenEncoder(num_bits=nbits, **encoder)

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        return self.hidden_encoder(imgs * 2 - 1, 2 * msgs.float() - 1)


@dataclasses.dataclass
class EmbedderSpec:
    module: nn.Module
    yuv: bool
    nbits: int
    out_channels: int


def build_embedder(name: str, cfg: dict, nbits: int,
                   hidden_size_multiplier: float = 2.0) -> EmbedderSpec:
    """Registry keyed by name prefix (unet*, hidden*); 'yuv' in the name
    marks luminance input."""
    hidden_size = int(nbits * hidden_size_multiplier)
    cfg = dict(cfg or {})
    if name.startswith("hidden"):
        return EmbedderSpec(module=HiddenEmbedder(nbits, **cfg), yuv="yuv" in name,
                            nbits=nbits, out_channels=cfg.get("out_channels", 3))
    if not name.startswith("unet"):
        raise NotImplementedError(
            f"Embedder {name}: only the unet* and hidden* embedders are ported; the vae "
            "and dvmark embedders come with ROADMAP.md 1.9")
    unet = dict(cfg.get("unet", {}))
    mp = cfg.get("msg_processor", {})
    if "msg_processor_type" in mp:
        unet.setdefault("msg_processor_type", mp["msg_processor_type"])
    module = UnetEmbedder(nbits=nbits, hidden_size=hidden_size, unet=unet)
    return EmbedderSpec(module=module, yuv="yuv" in name, nbits=nbits,
                        out_channels=unet.get("out_channels", 3))
