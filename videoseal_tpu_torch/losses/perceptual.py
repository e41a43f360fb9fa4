"""Perceptual loss registry and string combinator, counterpart of
``videoseal_tpu/losses/perceptual.py``.

Syntax: "yuv", "lpips+0.1_mse", "0.5_ssim+focal", ... Each base loss is a
function (imgs, imgs_w) -> scalar tensor over NHWC images in [0, 1]. The
released cards trained with "yuv" (videoseal_1.0) and "mse"
(videoseal_0.0); the VGG distances (lpips, watson_vgg, dists) load converted
weights through ``losses/lpips.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..modules.jnd import JND
from ..ops.color import rgb_to_yuv
from ..ops.metrics import ms_ssim as _ms_ssim
from ..ops.metrics import ssim as _ssim

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def none_loss(x, y):
    return torch.zeros((), device=x.device)


def mse_loss(x, y):
    return torch.mean((x - y) ** 2)


def yuv_loss(x, y):
    """MSE in YUV space: videoseal_1.0's training loss."""
    return torch.mean((rgb_to_yuv(x) - rgb_to_yuv(y)) ** 2)


def ssim_loss(x, y):
    return 1.0 - torch.mean(_ssim(y, x))


def msssim_loss(x, y):
    return 1.0 - torch.mean(_ms_ssim(y, x))


_jnd = JND(in_channels=1, out_channels=1)


def jnd_loss(x, y):
    """MSE between |delta| and the JND heatmap."""
    return torch.mean((torch.abs(y - x) - _jnd.heatmaps(x)) ** 2)


def focal_loss(x, y, alpha: float = 1.0):
    """Focal frequency loss (patch_factor 1) on NHWC input: the squared
    distance of the ortho 2D FFTs, weighted by its own normalised magnitude,
    the weight taking no gradient."""
    xf = torch.fft.fft2(torch.movedim(x, -1, 1), norm="ortho")
    yf = torch.fft.fft2(torch.movedim(y, -1, 1), norm="ortho")
    d2 = (xf.real - yf.real) ** 2 + (xf.imag - yf.imag) ** 2      # (B, C, H, W)
    w = torch.sqrt(d2) ** alpha
    wmax = torch.amax(w, dim=(-2, -1), keepdim=True)
    w = torch.clamp(torch.nan_to_num(w / torch.clamp(wmax, min=1e-12)), 0.0, 1.0)
    return torch.mean(w.detach() * d2)


_REGISTRY: dict[str, LossFn] = {
    "none": none_loss,
    "mse": mse_loss,
    "yuv": yuv_loss,
    "ssim": ssim_loss,
    "msssim": msssim_loss,
    "jnd": jnd_loss,
    "focal": focal_loss,
}


def build_loss(name: str, weights_dir: str | None = None) -> LossFn:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name == "watson_dft":
        from .watson_fft import watson_fft_loss
        return watson_fft_loss
    if name in ("lpips", "watson_vgg", "dists"):
        from . import lpips as _lp
        return _lp.build(name, weights_dir)
    raise ValueError(f"Loss type {name} not supported.")


def build_perceptual_loss(percep_loss: str, weights_dir: str | None = None) -> LossFn:
    """Parse 'lpips+0.1_mse'-style strings: terms joined by '+', each an
    optional 'weight_' then a loss name (names may hold '_', as watson_vgg
    does, so a term splits only where its head parses as a number)."""
    terms: list[tuple[float, LossFn]] = []
    for part in percep_loss.split("+"):
        w, key = 1.0, part
        if "_" in part:
            head, rest = part.split("_", 1)
            try:
                w, key = float(head), rest
            except ValueError:
                pass
        terms.append((w, build_loss(key, weights_dir)))

    def combined(x, y):
        total = torch.zeros((), device=x.device)
        for w, fn in terms:
            total = total + w * torch.mean(fn(x, y))
        return total

    return combined


class PerceptualLoss:
    """Callable wrapper over `build_perceptual_loss`, as the reference's
    class."""

    def __init__(self, percep_loss: str, weights_dir: str | None = None):
        self.percep_loss = percep_loss
        self._fn = build_perceptual_loss(percep_loss, weights_dir)

    def __call__(self, imgs, imgs_w):
        return self._fn(imgs, imgs_w)

    def __repr__(self):
        return f"PerceptualLoss(percep_loss={self.percep_loss})"
