"""Extractor wrapper and builder, counterpart of ``videoseal_tpu/models/extractor.py``.

An extractor maps [0,1] NHWC images to (B, 1 + nbits) logits, or pixelwise
to (B, H, W, 1 + nbits): the first is the detection logit, the rest are the
bit logits.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..modules.convnext import ConvNeXtV2
from ..modules.dino import DINO_PRESETS, DinoViT
from ..modules.dvmark import DVMarkDecoder
from ..modules.hidden import HiddenDecoder
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


class DinoExtractor(nn.Module):
    """DINOv2 ViT + PixelDecoder over the hooked blocks' concatenated maps."""

    def __init__(self, encoder: dict, pixel_decoder: dict):
        super().__init__()
        self.image_encoder = DinoViT(**encoder)
        self.pixel_decoder = PixelDecoder(**pixel_decoder)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.pixel_decoder(self.image_encoder(imgs * 2 - 1))


class DVMarkExtractor(nn.Module):
    """DVMark's 3D-conv decoder on the [0, 1] frames as they are: the
    reference registers it without the [-1, 1] preprocess."""

    def __init__(self, nbits: int):
        super().__init__()
        self.dvmark_decoder = DVMarkDecoder(nbits)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.dvmark_decoder(imgs)


class HiddenExtractor(nn.Module):
    """The HiDDeN decoder, from the preset's keys (HiddenDecoder's)."""

    def __init__(self, nbits: int, **decoder):
        super().__init__()
        self.hidden_decoder = HiddenDecoder(num_bits=nbits, **decoder)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.hidden_decoder(imgs * 2 - 1)


@dataclasses.dataclass
class ExtractorSpec:
    module: nn.Module
    nbits: int
    pixelwise: bool


def build_extractor(name: str, cfg: dict, img_size: int, nbits: int) -> ExtractorSpec:
    """Registry keyed by name prefix: convnext*, sam*, dino2*, hidden* and dvmark*."""
    cfg = {k: dict(v) if isinstance(v, dict) else v for k, v in (cfg or {}).items()}
    enc = cfg.get("encoder", {})
    pd = cfg.get("pixel_decoder", {})
    pd["nbits"] = nbits
    if name.startswith("sam"):
        enc["img_size"] = img_size
        pd.setdefault("embed_dim", enc.get("out_chans", 256))
        return ExtractorSpec(SegmentationExtractor(encoder=enc, pixel_decoder=pd), nbits,
                             pd.get("pixelwise", False))
    if name.startswith("dino2"):
        # the preset by encoder.name; of the encoder's keys only the hooks count
        preset = dict(DINO_PRESETS[enc.get("name", "dinov2_vits14")])
        preset["hook_indices"] = tuple(enc.get("hook_indices", (8, 9, 10, 11)))
        pd.setdefault("embed_dim", len(preset["hook_indices"]) * preset["embed_dim"])
        return ExtractorSpec(DinoExtractor(encoder=preset, pixel_decoder=pd), nbits,
                             pd.get("pixelwise", False))
    if name.startswith("hidden"):
        dec = {k: v for k, v in cfg.items() if k != "num_bits"}
        return ExtractorSpec(HiddenExtractor(nbits, **dec), nbits, dec.get("pixelwise", False))
    if name.startswith("dvmark"):
        return ExtractorSpec(DVMarkExtractor(nbits), nbits, False)
    if not name.startswith("convnext"):
        raise NotImplementedError(f"Extractor {name} not implemented")
    if cfg.get("proportional_dim", False):
        # chunkyseal: the dims scale with sqrt(nbits / 128)
        mult = math.sqrt(nbits / 128)
        enc = dict(enc, dims=[int(d * mult) for d in enc["dims"]])
    pd["embed_dim"] = enc.get("dims", (96, 192, 384, 768))[-1]
    return ExtractorSpec(ConvnextExtractor(encoder=enc, pixel_decoder=pd), nbits,
                         pd.get("pixelwise", False))
