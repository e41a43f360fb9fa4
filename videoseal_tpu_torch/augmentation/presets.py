"""The augmentation pools of ``videoseal_tpu/configs/augs_*.yaml`` as Python
data (the card's machine has no YAML parser); ``build_augmenter`` takes
each. ``tests/test_torch_augs.py`` holds them equal to the YAML files.
"""

AUGS = {
    # the geometric-robustness training pool: geometric draws dominate
    "augs_geometric": {
        "masks": {"kind": None},
        "augs": {"identity": 2, "rotate": 5, "crop": 5, "perspective": 5, "jpeg": 2,
                 "resize": 1, "hflip": 1, "gaussian_blur": 1, "brightness": 1,
                 "contrast": 1, "saturation": 1, "hue": 1, "h264": 1, "h265": 1},
        "augs_params": {
            "rotate": {"min_angle": -45, "max_angle": 45, "do90": True},
            "crop": {"min_size": 0.25, "max_size": 1.0},
            "perspective": {"min_distortion_scale": 0.1, "max_distortion_scale": 0.7},
            "jpeg": {"min_quality": 40, "max_quality": 80},
            "resize": {"min_size": 0.5, "max_size": 1.5},
            "gaussian_blur": {"min_kernel_size": 3, "max_kernel_size": 17},
            "brightness": {"min_factor": 0.5, "max_factor": 2},
            "contrast": {"min_factor": 0.5, "max_factor": 2.0},
            "saturation": {"min_factor": 0.5, "max_factor": 2},
            "hue": {"min_factor": -0.1, "max_factor": 0.1},
            "h264": {"min_crf": 28, "max_crf": 36},
            "h265": {"min_crf": 28, "max_crf": 36},
        },
    },
    # concentrated on the hard end of the rotate / crop / perspective rows
    "augs_geometric_hard": {
        "masks": {"kind": None},
        "augs": {"identity": 1, "rotate": 5, "crop": 6, "perspective": 5, "jpeg": 1},
        "augs_params": {
            "rotate": {"min_angle": -40, "max_angle": 40, "do90": False},
            "crop": {"min_size": 0.25, "max_size": 0.85},
            "perspective": {"min_distortion_scale": 0.2, "max_distortion_scale": 0.6},
            "jpeg": {"min_quality": 40, "max_quality": 80},
        },
    },
    # the geometric warm-up: ranges matched to the validation grid
    "augs_geometric_warm": {
        "masks": {"kind": None},
        "augs": {"identity": 2, "rotate": 5, "crop": 5, "perspective": 5, "jpeg": 2,
                 "resize": 1, "gaussian_blur": 1, "brightness": 1},
        "augs_params": {
            "rotate": {"min_angle": -35, "max_angle": 35, "do90": False},
            "crop": {"min_size": 0.3, "max_size": 1.0},
            "perspective": {"min_distortion_scale": 0.1, "max_distortion_scale": 0.6},
            "jpeg": {"min_quality": 40, "max_quality": 80},
            "resize": {"min_size": 0.5, "max_size": 1.5},
            "gaussian_blur": {"min_kernel_size": 3, "max_kernel_size": 17},
            "brightness": {"min_factor": 0.5, "max_factor": 2},
        },
    },
    # identity only: the decode-loss warm start
    "augs_identity": {"masks": {"kind": None}, "augs": {"identity": 1}, "augs_params": {}},
}
