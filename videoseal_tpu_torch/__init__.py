"""videoseal_tpu_torch: the PyTorch/CUDA port of videoseal_tpu.

The planar serving path (embed -> detect over padded planar u8 frames) runs
on an NVIDIA H100 through two hand-written Hopper kernels, and on the CPU
through their plain PyTorch versions. This package imports torch and numpy,
never jax, flax or yaml.
"""

from .kernels.fused_planar import pack_planar, planar_shape, unpack_planar
from .models.videoseal import PipelineConfig, VideoSeal, aggregate_message
from .utils.cfg import load, load_card

__all__ = ["PipelineConfig", "VideoSeal", "aggregate_message", "load", "load_card",
           "pack_planar", "planar_shape", "unpack_planar"]
