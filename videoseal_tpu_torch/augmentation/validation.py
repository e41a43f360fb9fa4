"""Validation attack grids, counterpart of
``videoseal_tpu/augmentation/validation.py``: lists of
``(aug, [strength, ...])``, the robustness evaluation grid.

The codec rows follow the JAX package's rule (``_codec``): the exact native
codec where the media runtime loads and has the codec, the on-device proxy
elsewhere. That is the reference's semantics, not a device fallback; the
row's ``aug`` column names the class that ran.
"""

from __future__ import annotations

from . import augs as A


class Sequential(A.Aug):
    """Chain augs; ``apply_strength`` takes one strength per aug."""

    def __init__(self, *augs):
        self.augs = augs
        self.name = "+".join(a.name for a in augs)

    def apply(self, generator, img, mask):
        for a in self.augs:
            img, mask = a.apply(generator, img, mask)
        return img, mask

    def apply_strength(self, img, mask, strengths):
        for a, s in zip(self.augs, strengths):
            img, mask = a.apply_strength(img, mask, s)
        return img, mask

    def __repr__(self):
        return "_".join(repr(a) for a in self.augs)


def _codec(codec: str):
    """The exact native codec when available, the differentiable proxy
    otherwise. (The JAX package's `jittable` flag, which forces the proxy
    for its jitted in-training eval, has no use here.)"""
    from .. import native
    if native.available() and native.codec_available(codec):
        return A.VideoCompressionExact(codec=codec)
    return A.VideoCompressionProxy(codec=codec)


def get_validation_augs_subset(is_video: bool = False) -> list:
    return [
        (A.Identity(), [0]),
        (A.Crop(), [0.71]),
        (A.Brightness(), [1.5]),
        (A.JPEG(), [60]) if not is_video else (_codec("h264"), [30]),
    ]


def get_validation_augs_geometric(is_video: bool = False) -> list:
    """A compact grid for tracking geometric robustness in training (not a
    reference grid: the subset grid has no rotate or perspective row)."""
    return [
        (A.Identity(), [0]),
        (A.Rotate(), [10, 30]),
        (A.Crop(), [0.5]),
        (A.Perspective(), [0.3, 0.5]),
        (A.Brightness(), [1.5]),
        (A.JPEG(), [60]) if not is_video else (_codec("h264"), [30]),
    ]


def get_combined_augs(is_video: bool = False) -> list:
    first = _codec("h264") if is_video else A.JPEG()
    vals = [23, 30, 40, 50] if is_video else [40, 60, 80]
    return [(Sequential(first, A.Crop(), A.Brightness()), [(v, 0.71, 0.5)]) for v in vals]


def get_validation_augs(is_video: bool = False, only_identity: bool = False,
                        only_combined: bool = False, extended: bool = False) -> list:
    """The reference's strength grids. `extended` adds the rows the
    reference registers but leaves out of its default grid: Saturation,
    MedianFilter and GaussianNoise sweeps for images, an AV1 CRF sweep for
    video."""
    if only_identity:
        return [(A.Identity(), [0])]
    if only_combined:
        return get_combined_augs(is_video)
    if is_video:
        extra = [(_codec("av1"), [30, 40, 50])] if extended else []
        return [
            (A.Identity(), [0]),
            (A.HorizontalFlip(), [0]),
            (A.Rotate(), [10, 90]),
            (A.Resize(), [0.55, 0.71]),
            (A.Crop(), [0.55, 0.71]),
            (A.Perspective(), [0.5]),
            (A.Brightness(), [0.5, 1.5]),
            (A.Contrast(), [0.5, 1.5]),
            (A.Saturation(), [0.5, 1.5]),
            (A.Hue(), [0.25]),
            (A.Grayscale(), [-1]),
            (A.JPEG(), [40]),
            (A.GaussianBlur(), [9]),
            (_codec("h264"), [23, 30, 40, 50]),
            (_codec("h264rgb"), [23, 30, 40, 50]),
            (_codec("h265"), [23, 30, 40, 50]),
            (_codec("vp9"), [-1]),   # the default-bitrate mode
            *extra,
            *get_combined_augs(is_video=True),
        ]
    extra = ([(A.Saturation(), [0.5, 1.0, 1.5, 2.0]),
              (A.MedianFilter(), [3, 5, 9, 13, 17]),
              (A.GaussianNoise(), [0.02, 0.04, 0.08, 0.12, 0.16])]
             if extended else [])
    return [
        (A.Identity(), [0]),
        (A.HorizontalFlip(), [0]),
        (A.Rotate(), [5, 10, 30, 45, 90]),
        (A.Resize(), [0.32, 0.45, 0.55, 0.63, 0.71, 0.77, 0.84, 0.89, 0.95, 1.00]),
        (A.Crop(), [0.32, 0.45, 0.55, 0.63, 0.71, 0.77, 0.84, 0.89, 0.95, 1.00]),
        (A.Perspective(), [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]),
        (A.Brightness(), [0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]),
        (A.Contrast(), [0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]),
        (A.Hue(), [-0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]),
        (A.Grayscale(), [-1]),
        (A.JPEG(), [40, 50, 60, 70, 80, 90]),
        (A.GaussianBlur(), [3, 5, 9, 13, 17]),
        *extra,
        *get_combined_augs(is_video=False),
    ]
