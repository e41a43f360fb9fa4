"""videoseal_tpu_torch: the PyTorch/CUDA port of videoseal_tpu.

Two paths run on an NVIDIA H100 through hand-written Hopper kernels, and on
the CPU through their plain PyTorch versions: the NHWC path
(``VideoSeal.embed / detect / extract_message``, float or u8 frames) and the
planar serving path (embed -> detect over padded planar u8 frames). Models
build on the card unless the caller passes ``device="cpu"``. This package
imports torch and numpy, never jax, flax or yaml.
"""

from .kernels.fused_planar import pack_planar, planar_shape, unpack_planar
from .models.blender import blend
from .models.videoseal import PipelineConfig, VideoSeal, aggregate_message
from .utils.cfg import load, load_card

__all__ = ["PipelineConfig", "VideoSeal", "aggregate_message", "blend", "load", "load_card",
           "pack_planar", "planar_shape", "unpack_planar"]
