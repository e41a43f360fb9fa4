"""videoseal_tpu_torch: the PyTorch/CUDA port of videoseal_tpu.

Two paths run on an NVIDIA H100 through hand-written Hopper kernels, and on
the CPU through their plain PyTorch versions: the NHWC path
(``VideoSeal.embed / detect / extract_message``, float or u8 frames) and the
planar serving path (embed -> detect over padded planar u8 frames). Video
files stream through ``inference_streaming``. Models build on the card
unless the caller passes ``device="cpu"``, from a card name or a checkpoint
path (``load``); ``save_npz`` writes the JAX package's checkpoint format.
The attack simulator (``augmentation``) and the robustness eval
(``evals.full``) run embed -> attack -> detect over the validation grids.
This package imports torch, numpy and scipy, never jax, flax, yaml or
pandas.
"""

from .kernels.fused_planar import pack_planar, planar_shape, unpack_planar
from .models.blender import blend
from .models.videoseal import PipelineConfig, VideoSeal, aggregate_message
from .utils.cfg import load, load_card, setup_model_from_model_card
from .utils.checkpoint import save_npz

__all__ = ["PipelineConfig", "VideoSeal", "aggregate_message", "blend", "load", "load_card",
           "pack_planar", "planar_shape", "save_npz", "setup_model_from_model_card",
           "unpack_planar"]
