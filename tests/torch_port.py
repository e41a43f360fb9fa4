"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Builds a tiny card in both packages with the same weights: the JAX model is
initialised from a seed, its BatchNorm statistics and GRN parameters are
randomised with numpy (their init values would hide bugs), and the port gets
the weights through ``videoseal_tpu_torch.utils.convert.from_jax_variables``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

NBITS = 16
# detector logits: every ConvNeXt block of the port goes through K2, which
# rounds to bf16 inside as the TPU kernel does, while the JAX extractor on the
# CPU is the all-f32 linen module; the planar fused detect input also differs
# by bf16 rounding of the downscale
LOGIT_ATOL = 3e-2


def tiny_card(img_size: int = 128, step: int = 2, chunk: int = 4, out_channels: int = 1,
              blending: str = "additive", video_mode: str = "repeat") -> dict:
    """The tiny card of tests/test_e2e_golden.py, at a given processing size.
    out_channels=3 makes an RGB-in, RGB-out embedder (chunkyseal's layout)."""
    yuv = out_channels == 1
    return {
        "args": {"attenuation": "jnd_1_1", "nbits": NBITS,
                 "hidden_size_multiplier": 2, "img_size_proc": img_size,
                 "blending_method": blending, "scaling_w": 0.2,
                 "scaling_i": 1.0, "videoseal_chunk_size": chunk,
                 "videoseal_step_size": step, "video_mode": video_mode},
        "embedder": {"model": "unet_tiny_yuv" if yuv else "unet_tiny", "params": {
            "msg_processor": {"msg_processor_type": "binary+concat"},
            "unet": {"in_channels": 1 if yuv else 3, "out_channels": out_channels,
                     "z_channels": 4,
                     "num_blocks": 1, "activation": "relu",
                     "normalization": "batch", "z_channels_mults": [1, 2],
                     "last_tanh": True}}},
        "extractor": {"model": "convnext_tiny", "params": {
            "encoder": {"depths": [1, 1, 1, 1], "dims": [8, 16, 32, 64]},
            "pixel_decoder": {"pixelwise": False, "upscale_stages": [1],
                              "embed_dim": 64, "sigmoid_output": False}}},
    }


def tiny_card_v0(img_size: int = 64, step: int = 2, chunk: int = 4) -> dict:
    """videoseal_0.0's layout at narrow widths: an RGB unet_small2 with SiLU
    and RMS norms, the SAM ViT extractor (depth 2, embed_dim 48, 2 heads,
    window 4, global attention at block 1), no JND, scaling_w 1."""
    return {
        "args": {"attenuation": None, "nbits": NBITS, "hidden_size_multiplier": 2,
                 "img_size_proc": img_size, "blending_method": "additive",
                 "scaling_w": 1.0, "scaling_i": 1.0, "videoseal_chunk_size": chunk,
                 "videoseal_step_size": step, "video_mode": "repeat"},
        "embedder": {"model": "unet_small2", "params": {
            "msg_processor": {"msg_processor_type": "binary+concat"},
            "unet": {"in_channels": 3, "out_channels": 3, "z_channels": 4, "num_blocks": 1,
                     "activation": "silu", "normalization": "rms",
                     "z_channels_mults": [1, 2], "last_tanh": True}}},
        "extractor": {"model": "sam_small", "params": {
            "encoder": {"embed_dim": 48, "out_chans": 48, "depth": 2, "num_heads": 2,
                        "patch_size": 16, "global_attn_indexes": [1], "window_size": 4,
                        "mlp_ratio": 4, "qkv_bias": True, "use_rel_pos": True},
            "pixel_decoder": {"pixelwise": False, "upscale_stages": [1], "embed_dim": 48,
                              "sigmoid_output": False, "upscale_type": "bilinear"}}},
    }


def tiny_preset_card(img_size: int = 64, step: int = 2) -> tuple[dict, dict]:
    """(card, training args) of the smallest presets a checkpoint's args can
    name (unet_tiny_yuv_quant, convnext_tiny), as
    ``utils.cfg.get_config_from_checkpoint`` rebuilds them from the args."""
    from videoseal_tpu_torch import presets

    args = {"embedder_model": "unet_tiny_yuv_quant", "extractor_model": "convnext_tiny",
            "nbits": NBITS, "img_size_proc": img_size, "attenuation": "jnd_1_1",
            "scaling_w": 0.2, "videoseal_step_size": step}
    card = {"args": dict(args, hidden_size_multiplier=2),
            "embedder": {"model": "unet_tiny_yuv_quant",
                         "params": copy.deepcopy(presets.EMBEDDER["unet_tiny_yuv_quant"])},
            "extractor": {"model": "convnext_tiny",
                          "params": copy.deepcopy(presets.EXTRACTOR["convnext_tiny"])}}
    return card, args


def _randomize(tree, rng, path=""):
    """Numpy copy of a variables tree with BN stats/affine, GRN, RMS norm
    gains and the ViT's position tables randomised."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(dict(v), rng, p)
            continue
        a = np.asarray(v, np.float32).copy()
        if (p.endswith("/bn/mean") or "/grn/" in p or p.endswith("/bn/bias")
                or "/rel_pos_" in p or p.endswith("/pos_embed")):
            a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        elif p.endswith("/bn/var") or p.endswith("/bn/scale") or p.endswith("/rms/gamma"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        out[k] = a
    return out


def jax_model(card: dict, seed: int = 0):
    """JAX VideoSeal for `card` with randomised BN/GRN variables (jitted
    init: eager linen init of the two modules takes ~30 s on the CPU)."""
    import jax
    import jax.numpy as jnp
    from videoseal_tpu.models.embedder import build_embedder
    from videoseal_tpu.models.extractor import build_extractor
    from videoseal_tpu.models.videoseal import PipelineConfig, VideoSeal
    from videoseal_tpu.modules.jnd import build_attenuation

    a, e, x = card["args"], card["embedder"], card["extractor"]
    s = a["img_size_proc"]
    emb = build_embedder(e["model"], e["params"], a["nbits"], a["hidden_size_multiplier"])
    ext = build_extractor(x["model"], x["params"], s, a["nbits"])
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    evars = jax.jit(emb.module.init)(k1, jnp.zeros((1, s, s, 1 if emb.yuv else 3)),
                                     jnp.zeros((1, a["nbits"]), jnp.int32))
    xvars = jax.jit(ext.module.init)(k2, jnp.zeros((1, s, s, 3)))
    cfg = PipelineConfig(img_size=s, blending_method=a["blending_method"],
                         chunk_size=a["videoseal_chunk_size"],
                         step_size=a["videoseal_step_size"], video_mode=a["video_mode"],
                         yuv=emb.yuv, nbits=a["nbits"])
    rng = np.random.default_rng(seed + 100)
    return VideoSeal(emb, ext, _randomize(evars, rng), _randomize(xvars, rng),
                     build_attenuation(a["attenuation"]), cfg,
                     scaling_w=a["scaling_w"], scaling_i=a["scaling_i"], card=card)


def port_model(card: dict, jm):
    """Port VideoSeal for `card` holding the weights of JAX model `jm`."""
    from videoseal_tpu_torch import VideoSeal
    from videoseal_tpu_torch.utils.convert import from_jax_variables

    model = VideoSeal.from_card(copy.deepcopy(card), device="cpu")
    emb, ext = from_jax_variables(jm.embedder_vars, jm.extractor_vars)
    model.embedder.load_state_dict(emb)
    model.extractor.load_state_dict(ext)
    return model


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
