"""The model cards this port serves, as Python data.

The JAX package keeps them as YAML (``videoseal_tpu/cards/*.yaml``); the
machine that serves the port has no YAML parser, so they are carried here. A
CPU test holds them equal to ``yaml.safe_load`` of those files.
"""

CARDS = {
    "chunkyseal": {
        "checkpoint_path": None,
        "args": {
            "attenuation": "jnd_1_1",
            "nbits": 1024,
            "hidden_size_multiplier": 2.0,
            "img_size_proc": 256,
            "blending_method": "additive",
            "scaling_w": 0.2,
            "scaling_i": 1.0,
            "videoseal_chunk_size": 32,
            "videoseal_step_size": 8,
        },
        "embedder": {
            "model": "unet_chunky",
            "params": {
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
        },
        "extractor": {
            "model": "convnext_chunky",
            "params": {
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
        },
    },
    "pixelseal": {
        "checkpoint_path": None,
        "args": {
            "attenuation": "jnd_1_1",
            "nbits": 256,
            "hidden_size_multiplier": 1.0,
            "img_size_proc": 256,
            "blending_method": "additive",
            "scaling_w": 0.2,
            "scaling_i": 1.0,
            "videoseal_chunk_size": 32,
            "videoseal_step_size": 8,
        },
        "embedder": {
            "model": "unet_base_yuv_quant",
            "params": {
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
        },
        "extractor": {
            "model": "convnext_tiny",
            "params": {
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
        },
    },
    "videoseal_0.0": {
        "checkpoint_path": None,
        "args": {
            "attenuation": None,
            "nbits": 96,
            "hidden_size_multiplier": 2.0,
            "img_size_proc": 256,
            "blending_method": "additive",
            "scaling_w": 1.0,
            "scaling_i": 1.0,
            "videoseal_chunk_size": 32,
            "videoseal_step_size": 4,
        },
        "embedder": {
            "model": "unet_small2",
            "params": {
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
        },
        "extractor": {
            "model": "sam_small",
            "params": {
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
        },
    },
    "videoseal_1.0": {
        "checkpoint_path": None,
        "args": {
            "attenuation": "jnd_1_1",
            "nbits": 256,
            "hidden_size_multiplier": 1,
            "img_size_proc": 256,
            "blending_method": "additive",
            "scaling_w": 0.2,
            "scaling_i": 1.0,
            "videoseal_chunk_size": 32,
            "videoseal_step_size": 4,
        },
        "embedder": {
            "model": "unet_small2_yuv_quant",
            "params": {
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
        },
        "extractor": {
            "model": "convnext_tiny",
            "params": {
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
        },
    },
}
