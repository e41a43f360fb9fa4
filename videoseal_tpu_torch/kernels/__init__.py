"""Hand-written Hopper kernels (CUDA C++ in ../csrc) with their plain versions.

K1 fused_planar.fused_jnd_blend_planar, K2 convnext_block.convnext_block_fused,
K3 convnext_block.convnext_blocks_fused, K4 fused_blend.fused_jnd_delta_up (and its
blend mode fused_blend.fused_jnd_blend_up),
K5 fused_blend.fused_jnd_delta, K6 fused_blend.fused_jnd_blend, and the
attribution probes K7 jnd_probe.jnd_probe and K8 convnext_probe.convnext_probe.

unet_fused is no kernel: it is the JAX package's serving UNet
(``videoseal_tpu/kernels/unet_fused.py``), the UNet with BatchNorm folded
into its cuDNN convs, which ``VideoSeal.with_dtype`` serves.
"""

from .fused_blend import fused_jnd_blend, supports_fused_blend

__all__ = ["fused_jnd_blend", "supports_fused_blend"]
