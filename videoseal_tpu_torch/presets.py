"""The embedder and extractor presets, as Python data.

The JAX package keeps them as YAML (``videoseal_tpu/configs/embedder.yaml``,
``extractor.yaml``); a checkpoint's training args name a preset
(``embedder_model``, ``extractor_model``) or take the file's default
(``model``). The machine that serves the port has no YAML parser, so they
are carried here, as ``cards.py`` carries the cards. A CPU test holds them
equal to ``yaml.safe_load`` of those files.
"""

EMBEDDER = {
    "model": "unet_small2_yuv_quant",
    "hidden": {
        "num_blocks": 4,
        "in_channels": 3,
        "out_channels": 3,
        "z_channels": 64,
        "normalization": "group",
        "activation": "gelu",
        "last_tanh": True,
    },
    "unet_small2_quant": {
        "msg_processor": {
            "msg_processor_type": "binary+concat",
        },
        "unet": {
            "in_channels": 3,
            "out_channels": 3,
            "z_channels": 16,
            "num_blocks": 8,
            "activation": "relu",
            "normalization": "batch",
            "z_channels_mults": [1, 2, 4, 8],
            "last_tanh": True,
        },
    },
    "unet_small2_yuv_quant": {
        "msg_processor": {
            "msg_processor_type": "binary+concat",
        },
        "unet": {
            "in_channels": 1,
            "out_channels": 1,
            "z_channels": 16,
            "num_blocks": 8,
            "activation": "relu",
            "normalization": "batch",
            "z_channels_mults": [1, 2, 4, 8],
            "last_tanh": True,
        },
    },
    "unet_base_yuv_quant": {
        "msg_processor": {
            "msg_processor_type": "binary+concat",
        },
        "unet": {
            "in_channels": 1,
            "out_channels": 1,
            "z_channels": 16,
            "num_blocks": 8,
            "activation": "relu",
            "normalization": "batch",
            "z_channels_mults": [2, 4, 8, 16],
            "last_tanh": True,
        },
    },
    "unet_tiny_yuv_quant": {
        "msg_processor": {
            "msg_processor_type": "binary+concat",
        },
        "unet": {
            "in_channels": 1,
            "out_channels": 1,
            "z_channels": 8,
            "num_blocks": 4,
            "activation": "relu",
            "normalization": "batch",
            "z_channels_mults": [1, 2, 4, 8],
            "last_tanh": True,
        },
    },
    "unet_small2": {
        "msg_processor": {
            "msg_processor_type": "binary+concat",
        },
        "unet": {
            "in_channels": 3,
            "out_channels": 3,
            "z_channels": 16,
            "num_blocks": 8,
            "activation": "silu",
            "normalization": "rms",
            "z_channels_mults": [1, 2, 4, 8],
            "last_tanh": True,
        },
    },
    "unet_chunky": {
        "msg_processor": {
            "msg_processor_type": "binary+concat",
        },
        "unet": {
            "in_channels": 3,
            "out_channels": 3,
            "z_channels": 16,
            "num_blocks": 8,
            "activation": "relu",
            "normalization": "batch",
            "z_channels_mults": [4, 8, 16, 32],
            "last_tanh": True,
        },
    },
    "unet_small2_yuv_quant_2p1d": {
        "msg_processor": {
            "msg_processor_type": "binary+concat",
        },
        "unet": {
            "in_channels": 1,
            "out_channels": 1,
            "z_channels": 16,
            "num_blocks": 8,
            "activation": "relu",
            "normalization": "batch",
            "z_channels_mults": [1, 2, 4, 8],
            "last_tanh": True,
            "conv_layer": "conv2p1d",
        },
    },
}

EXTRACTOR = {
    "model": "convnext_tiny",
    "hidden": {
        "num_blocks": 8,
        "in_channels": 3,
        "z_channels": 64,
        "normalization": "group",
        "activation": "gelu",
    },
    "sam_small": {
        "encoder": {
            "embed_dim": 384,
            "out_chans": 384,
            "depth": 12,
            "num_heads": 6,
            "patch_size": 16,
            "global_attn_indexes": [2, 5, 8, 11],
            "window_size": 8,
            "mlp_ratio": 4,
            "qkv_bias": True,
            "use_rel_pos": True,
        },
        "pixel_decoder": {
            "pixelwise": False,
            "upscale_stages": [1],
            "embed_dim": 384,
            "sigmoid_output": False,
            "upscale_type": "bilinear",
        },
    },
    "sam_small_pw": {
        "encoder": {
            "embed_dim": 384,
            "out_chans": 384,
            "depth": 12,
            "num_heads": 6,
            "patch_size": 16,
            "global_attn_indexes": [2, 5, 8, 11],
            "window_size": 8,
            "mlp_ratio": 4,
            "qkv_bias": True,
            "use_rel_pos": True,
        },
        "pixel_decoder": {
            "pixelwise": True,
            "upscale_stages": [4, 2, 2],
            "embed_dim": 384,
            "sigmoid_output": False,
            "upscale_type": "bilinear",
        },
    },
    "convnext_tiny": {
        "encoder": {
            "depths": [3, 3, 9, 3],
            "dims": [96, 192, 384, 768],
        },
        "pixel_decoder": {
            "pixelwise": False,
            "upscale_stages": [1],
            "embed_dim": 768,
            "sigmoid_output": False,
        },
    },
    "convnext_tiny_pw": {
        "encoder": {
            "depths": [3, 3, 9, 3],
            "dims": [96, 192, 384, 768],
        },
        "pixel_decoder": {
            "pixelwise": True,
            "upscale_stages": [4, 2, 2],
            "embed_dim": 768,
            "sigmoid_output": False,
        },
    },
    "convnext_chunky": {
        "proportional_dim": True,
        "encoder": {
            "stem_stride": 2,
            "depths": [3, 3, 27, 3],
            "dims": [128, 256, 512, 1024],
        },
        "pixel_decoder": {
            "pixelwise": False,
            "upscale_stages": [1],
            "sigmoid_output": False,
        },
    },
    "convnext_tiny_temporal": {
        "encoder": {
            "depths": [3, 3, 9, 3],
            "dims": [96, 192, 384, 768],
            "temporal_convs": True,
        },
        "pixel_decoder": {
            "pixelwise": False,
            "upscale_stages": [1],
            "embed_dim": 768,
            "sigmoid_output": False,
        },
    },
}
