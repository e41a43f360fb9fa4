"""Hand-written Hopper kernels (CUDA C++ in ../csrc) with their plain versions.

K1 fused_planar.fused_jnd_blend_planar, K2 convnext_block.convnext_block_fused,
K3 convnext_block.convnext_blocks_fused, K4 fused_blend.fused_jnd_delta_up (and its
blend mode fused_blend.fused_jnd_blend_up),
K5 fused_blend.fused_jnd_delta, K6 fused_blend.fused_jnd_blend, and the
attribution probes K7 jnd_probe.jnd_probe and K8 convnext_probe.convnext_probe.
"""
