"""Extractor wrapper and builder, counterpart of ``videoseal_tpu/models/extractor.py``.

An extractor maps [0,1] NHWC images to (B, 1 + nbits) logits: the first is
the detection logit, the rest are the bit logits.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..modules.convnext import ConvNeXtV2
from ..modules.pixel_decoder import PixelDecoder
from ..modules.vit import ImageEncoderViT


class ConvnextExtractor(nn.Module):
    def __init__(self, encoder: dict, pixel_decoder: dict):
        super().__init__()
        self.convnext = ConvNeXtV2(**encoder)
        self.pixel_decoder = PixelDecoder(**pixel_decoder)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.pixel_decoder(self.convnext(imgs * 2 - 1))


class SegmentationExtractor(nn.Module):
    """SAM-style ViT encoder + PixelDecoder (videoseal_0.0's sam_small)."""

    def __init__(self, encoder: dict, pixel_decoder: dict):
        super().__init__()
        self.image_encoder = ImageEncoderViT(**encoder)
        self.pixel_decoder = PixelDecoder(**pixel_decoder)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.pixel_decoder(self.image_encoder(imgs * 2 - 1))


@dataclasses.dataclass
class ExtractorSpec:
    module: nn.Module
    nbits: int
    pixelwise: bool


def build_extractor(name: str, cfg: dict, img_size: int, nbits: int) -> ExtractorSpec:
    """Registry keyed by name prefix: convnext* and sam* (the four cards'
    extractors)."""
    cfg = {k: dict(v) if isinstance(v, dict) else v for k, v in (cfg or {}).items()}
    enc = cfg.get("encoder", {})
    pd = cfg.get("pixel_decoder", {})
    pd["nbits"] = nbits
    if name.startswith("sam"):
        enc["img_size"] = img_size
        pd.setdefault("embed_dim", enc.get("out_chans", 256))
        return ExtractorSpec(SegmentationExtractor(encoder=enc, pixel_decoder=pd), nbits,
                             pd.get("pixelwise", False))
    if not name.startswith("convnext"):
        raise NotImplementedError(
            f"Extractor {name}: only the convnext* and sam* extractors are ported; "
            "dino/hidden/dvmark come with ROADMAP.md 1.9")
    if cfg.get("proportional_dim", False):
        # chunkyseal: the dims scale with sqrt(nbits / 128)
        mult = math.sqrt(nbits / 128)
        enc = dict(enc, dims=[int(d * mult) for d in enc["dims"]])
    pd["embed_dim"] = enc.get("dims", (96, 192, 384, 768))[-1]
    return ExtractorSpec(ConvnextExtractor(encoder=enc, pixel_decoder=pd), nbits,
                         pd.get("pixelwise", False))
