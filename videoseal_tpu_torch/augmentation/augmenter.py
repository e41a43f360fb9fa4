"""Augmenter: the probability-weighted attack sampler of the training path,
counterpart of ``videoseal_tpu/augmentation/augmenter.py``.

One aug per call for the whole batch, chosen with ``torch.multinomial`` on
the normalised probabilities (``num_augs`` in turn), after the watermark
mask blend when ``train=True``. Draws come from an explicit
``torch.Generator``; the codec names map to the on-device proxy, the
``*_exact`` names to the native codec with a straight-through gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from . import augs as A
from .masks import build_mask_sampler


def _proxy(codec):
    return lambda **kw: A.VideoCompressionProxy(codec=codec, **kw)


def _exact(codec):
    return lambda **kw: A.VideoCompressionExact(codec=codec, **kw)


name2aug = {
    "identity": A.Identity,
    "rotate": A.Rotate,
    "resize": A.Resize,
    "crop": A.Crop,
    "perspective": A.Perspective,
    "hflip": A.HorizontalFlip,
    "jpeg": A.JPEG,
    "gaussian_blur": A.GaussianBlur,
    "median_filter": A.MedianFilter,
    "brightness": A.Brightness,
    "contrast": A.Contrast,
    "saturation": A.Saturation,
    "hue": A.Hue,
    "gaussian_noise": A.GaussianNoise,
    "grayscale": A.Grayscale,
    "h264": _proxy("h264"),
    "h264rgb": _proxy("h264rgb"),
    "h265": _proxy("h265"),
    "video_compression": _proxy("h264"),
    "h264_exact": _exact("h264"),
    "h264rgb_exact": _exact("h264rgb"),
    "h265_exact": _exact("h265"),
    "vp9_exact": _exact("vp9"),
    "av1_exact": _exact("av1"),
    "speed_change": A.SpeedChange,
    "temporal_reorder": A.TemporalReorder,
    "window_averaging": A.WindowAveraging,
    "drop_frame": A.DropFrame,
}
video_augs = ["video_compression", "h264", "h264rgb", "h265",
              "h264_exact", "h264rgb_exact", "h265_exact", "vp9_exact",
              "av1_exact", "speed_change", "temporal_reorder",
              "window_averaging", "drop_frame"]


class Augmenter:
    def __init__(self, augs: dict, augs_params: dict, masks: dict | None = None,
                 num_augs: int = 1):
        self.num_augs = num_augs
        self.mask_sampler = build_mask_sampler(masks or {"kind": None})
        self.augs, self.probs = self._parse(augs, augs_params, is_video=False)
        self.augs_video, self.probs_video = self._parse(augs, augs_params, is_video=True)

    @staticmethod
    def _parse(augs: dict, augs_params: dict, is_video: bool):
        out, probs = [], []
        for name, p in augs.items():
            if name in video_augs and not is_video:
                continue
            if name not in name2aug:
                raise ValueError(f"Augmentation {name} not found. Add it in name2aug.")
            out.append(name2aug[name](**dict(augs_params.get(name, {}))))
            probs.append(float(p))
        pr = np.asarray(probs, np.float32)
        return out, pr / pr.sum()

    def aug_names(self, is_video: bool = False) -> list[str]:
        return [a.name for a in (self.augs_video if is_video else self.augs)]

    def __call__(self, generator: torch.Generator, imgs_w, imgs, masks=None,
                 is_video: bool = False, train: bool = True):
        """Returns (imgs_aug, mask_targets, [selected index, ...])."""
        augs = self.augs_video if is_video else self.augs
        probs = torch.as_tensor(self.probs_video if is_video else self.probs,
                                dtype=torch.float64, device=generator.device)
        if train:
            mask_targets = self.mask_sampler(generator, imgs_w, masks)
            imgs_aug = imgs_w * mask_targets + imgs * (1 - mask_targets)
        else:
            mask_targets = torch.ones_like(imgs_w[..., 0:1])
            imgs_aug = imgs_w
        selected = []
        for _ in range(self.num_augs):
            idx = int(torch.multinomial(probs, 1, generator=generator))
            imgs_aug, mask_targets = augs[idx].apply(generator, imgs_aug, mask_targets)
            selected.append(idx)
        return imgs_aug, mask_targets, selected


def get_dummy_augmenter() -> Augmenter:
    """The identity-only augmenter of inference."""
    return Augmenter(augs={"identity": 1}, augs_params={}, masks={"kind": None})


def build_augmenter(cfg: dict, num_augs: int = 1) -> Augmenter:
    """From an augs-config dict {masks, augs, augs_params}, such as
    ``presets.AUGS[name]``."""
    return Augmenter(augs=cfg.get("augs", {"identity": 1}),
                     augs_params=cfg.get("augs_params", {}),
                     masks=cfg.get("masks", {"kind": None}),
                     num_augs=num_augs)
