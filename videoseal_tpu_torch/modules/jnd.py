"""Just-Noticeable-Difference heatmap, counterpart of ``videoseal_tpu/modules/jnd.py``.

Plain torch on NHWC [0, 1] images: luminance masking (5x5 weighted kernel)
plus contrast masking (Sobel), combined with an overlap term.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1., 0., 1.), (-2., 0., 2.), (-1., 0., 1.))
_SOBEL_Y = ((1., 2., 1.), (0., 0., 0.), (-1., -2., -1.))
_LUM = ((1., 1., 1., 1., 1.),
        (1., 2., 2., 2., 1.),
        (1., 2., 0., 2., 1.),
        (1., 2., 2., 2., 1.),
        (1., 1., 1., 1., 1.))
_RGB_W = (0.299, 0.587, 0.114)


def _depthwise(x: torch.Tensor, kern2d) -> torch.Tensor:
    """Zero-padded depthwise stencil (cross-correlation) on NHWC."""
    k = torch.tensor(kern2d, dtype=x.dtype, device=x.device)
    c = x.shape[-1]
    wgt = k[None, None].expand(c, 1, *k.shape)
    y = F.conv2d(x.permute(0, 3, 1, 2), wgt, padding=k.shape[0] // 2, groups=c)
    return y.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class JND:
    """in_channels=1: luminance path; 3: per-channel. blue tints a 3-channel
    heatmap of the luminance path by [0.5, 0.5, 1.0]."""
    in_channels: int = 1
    out_channels: int = 3
    blue: bool = False

    def _la(self, x255, eps: float = 1e-5):
        la = _depthwise(x255, _LUM) / 32.0
        lo = 17.0 * (1.0 - torch.sqrt(torch.clamp(la, min=0.0) / 127.0 + eps))
        hi = 3.0 / 128.0 * (la - 127.0) + 3.0
        return torch.where(la <= 127.0, lo, hi)

    def _cm(self, x255, beta: float = 0.117):
        gx = _depthwise(x255, _SOBEL_X)
        gy = _depthwise(x255, _SOBEL_Y)
        cm = torch.sqrt(torch.clamp(gx * gx + gy * gy, min=1e-12))
        cm = 16.0 * cm ** 2.4 / (cm * cm + 26.0 ** 2)
        return beta * cm

    def heatmaps(self, imgs: torch.Tensor, clc: float = 0.3) -> torch.Tensor:
        """(..., H, W, 3) in [0,1] -> (..., H, W, out_channels)."""
        shape = imgs.shape
        x = imgs.reshape((-1,) + tuple(shape[-3:])).float() * 255.0
        if self.in_channels == 1:
            x = (_RGB_W[0] * x[..., 0] + _RGB_W[1] * x[..., 1]
                 + _RGB_W[2] * x[..., 2])[..., None]
        la = self._la(x)
        cm = self._cm(x)
        h = torch.clamp(la + cm - clc * torch.minimum(la, cm), min=0.0)
        if self.out_channels == 3 and self.in_channels == 1:
            h = h.expand(*h.shape[:-1], 3)
            if self.blue:
                h = h * torch.tensor((0.5, 0.5, 1.0), device=h.device)
        elif self.out_channels == 1 and self.in_channels == 3:
            h = torch.sum(h / 3.0, dim=-1, keepdim=True)
        h = h / 255.0
        return h.reshape(tuple(shape[:-1]) + (self.out_channels,)).to(imgs.dtype)

    def heatmap_lum(self, imgs: torch.Tensor, clc: float = 0.3) -> torch.Tensor:
        """in_channels=1 heatmap as shift-adds on the luminance plane:
        (..., H, W, 3) in [0,1] -> (..., H, W), the same math as
        `heatmaps(imgs)[..., 0]`."""
        shape = imgs.shape
        x = imgs.reshape((-1,) + tuple(shape[-3:])).float() * 255.0
        lum = _RGB_W[0] * x[..., 0] + _RGB_W[1] * x[..., 1] + _RGB_W[2] * x[..., 2]
        _, h, w = lum.shape
        p = F.pad(lum, (2, 2, 2, 2))

        def vsum(src, n, top):
            acc = src[:, top:top + h]
            for d in range(1, n):
                acc = acc + src[:, top + d:top + d + h]
            return acc

        def hsum(src, n, left):
            acc = src[:, :, left:left + w]
            for d in range(1, n):
                acc = acc + src[:, :, left + d:left + d + w]
            return acc

        col5, col3 = vsum(p, 5, 0), vsum(p, 3, 1)
        la = (hsum(col5, 5, 0) + hsum(col3, 3, 1) - 2.0 * lum) * (1.0 / 32.0)
        lo = 17.0 * (1.0 - torch.sqrt(torch.clamp(la, min=0.0) * (1.0 / 127.0) + 1e-5))
        hi = (3.0 / 128.0) * (la - 127.0) + 3.0
        la = torch.where(la <= 127.0, lo, hi)

        t = p[:, 1:1 + h] + 2.0 * p[:, 2:2 + h] + p[:, 3:3 + h]
        gx = t[:, :, 3:3 + w] - t[:, :, 1:1 + w]
        s_diff = p[:, 1:1 + h] - p[:, 3:3 + h]
        gy = s_diff[:, :, 1:1 + w] + 2.0 * s_diff[:, :, 2:2 + w] + s_diff[:, :, 3:3 + w]
        cm2 = gx * gx + gy * gy
        cm = torch.sqrt(torch.clamp(cm2, min=1e-12))
        cm = 0.117 * (16.0 * cm ** 2.4 / (cm2 + 26.0 ** 2))
        heat = torch.clamp(la + cm - clc * torch.minimum(la, cm), min=0.0)
        return (heat * (1.0 / 255.0)).reshape(tuple(shape[:-1])).to(imgs.dtype)

    def __call__(self, imgs: torch.Tensor, imgs_w: torch.Tensor) -> torch.Tensor:
        """imgs + heatmaps(imgs) * (imgs_w - imgs): the training path's
        attenuation after the blend."""
        return imgs + self.heatmaps(imgs) * (imgs_w - imgs)


def build_attenuation(name: str | None) -> JND | None:
    """Resolve 'jnd_I_O' names."""
    if name is None or str(name).lower() in ("none", "null", ""):
        return None
    if name.startswith("jnd"):
        parts = name.split("_")
        in_c = int(parts[1]) if len(parts) > 1 else 1
        out_c = int(parts[2]) if len(parts) > 2 else 3
        return JND(in_channels=in_c, out_channels=out_c)
    raise NotImplementedError(f"attenuation {name!r}")
