"""Embedder wrapper and builder, counterpart of ``videoseal_tpu/models/embedder.py``.

An embedder maps ([0,1] NHWC images, (B, nbits) messages) to a watermark
prediction in [-1, 1], NHWC; the x*2-1 preprocess lives inside.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..modules.dvmark import DVMarkEncoder
from ..modules.hidden import HiddenEncoder
from ..modules.msg_processor import MsgProcessor
from ..modules.unet import UNetMsg
from ..modules.vae import VAEDecoder, VAEEncoder


class UnetEmbedder(nn.Module):
    """`unet_cfg` keeps the UNet's settings, which
    ``kernels/unet_fused.supports_unet_fused`` reads."""

    def __init__(self, nbits: int, hidden_size: int, unet: dict):
        super().__init__()
        self.unet_cfg = dict(unet)
        self.unet = UNetMsg(nbits=nbits, hidden_size=hidden_size, **unet)

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        x = (imgs * 2 - 1).permute(0, 3, 1, 2)
        return self.unet(x, msgs).permute(0, 2, 3, 1)


class VAEEmbedder(nn.Module):
    """VAE encoder -> the message concatenated (or added) in the latent ->
    VAE decoder. The decoder's conv_in takes the width the message processor
    gives it, as flax infers it: the JAX builder's decoder ``z_channels``
    (hidden + z) is never read, and with ``double_z`` the concat is 2z +
    hidden wide (ROADMAP.md §3.36)."""

    def __init__(self, nbits: int, hidden_size: int, encoder: dict, decoder: dict,
                 msg_processor_type: str = "binary+concat"):
        super().__init__()
        self.encoder = VAEEncoder(**encoder)
        self.msg_processor = MsgProcessor(nbits, hidden_size, msg_processor_type)
        z = self.msg_processor.out_channels(self.encoder.conv_out.out_channels)
        self.decoder = VAEDecoder(**dict(decoder, z_channels=z))

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        z = self.encoder((imgs * 2 - 1).permute(0, 3, 1, 2))
        return self.decoder(self.msg_processor(z, msgs)).permute(0, 2, 3, 1)


class DVMarkEmbedder(nn.Module):
    """DVMark's 3D-conv encoder over the frames of the batch as one video."""

    def __init__(self, nbits: int, in_channels: int = 3):
        super().__init__()
        self.dvmark_encoder = DVMarkEncoder(nbits, in_channels)

    def forward(self, imgs: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        return self.dvmark_encoder(imgs * 2 - 1, msgs)


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
    """Registry keyed by name prefix (unet*, vae*, hidden*, dvmark*); 'yuv'
    in the name marks luminance input."""
    hidden_size = int(nbits * hidden_size_multiplier)
    cfg = dict(cfg or {})
    yuv = "yuv" in name
    if name.startswith("hidden"):
        return EmbedderSpec(module=HiddenEmbedder(nbits, **cfg), yuv=yuv,
                            nbits=nbits, out_channels=cfg.get("out_channels", 3))
    if name.startswith("dvmark"):
        return EmbedderSpec(module=DVMarkEmbedder(nbits, 1 if yuv else 3), yuv=yuv,
                            nbits=nbits, out_channels=3)
    if name.startswith("vae"):
        # the input is as wide as the pipeline makes it, as flax infers it
        enc = dict(cfg.get("encoder", {}), in_channels=1 if yuv else 3)
        dec = cfg.get("decoder", {})
        mp = cfg.get("msg_processor", {}).get("msg_processor_type", "binary+concat")
        return EmbedderSpec(module=VAEEmbedder(nbits, hidden_size, enc, dec, mp), yuv=yuv,
                            nbits=nbits, out_channels=dec.get("out_ch", 3))
    if not name.startswith("unet"):
        raise NotImplementedError(f"Embedder {name} not implemented")
    unet = dict(cfg.get("unet", {}))
    mp = cfg.get("msg_processor", {})
    if "msg_processor_type" in mp:
        unet.setdefault("msg_processor_type", mp["msg_processor_type"])
    module = UnetEmbedder(nbits=nbits, hidden_size=hidden_size, unet=unet)
    return EmbedderSpec(module=module, yuv=yuv, nbits=nbits,
                        out_channels=unet.get("out_channels", 3))
