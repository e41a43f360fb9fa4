"""Artificial FFT watermark generators, counterpart of
``videoseal_tpu/wmforger/generators.py``.

The spectra are synthesised on the host with numpy and Python's `random`,
exactly as the JAX package does, so the same seeds give the same patterns.
The pattern is blended into each image on the image's device, either
attenuated by the JND or with a plain alpha, and quantised to 8 bits.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from ..modules.jnd import JND
from ..ops.resize import resize_bilinear


class FFTWatermarkBase:
    def __init__(self, alpha_base, alpha_rand, jnd_alpha_base, jnd_alpha_rand):
        self.jnd = JND(in_channels=1, out_channels=3)
        self.alpha_base = alpha_base
        self.alpha_rand = alpha_rand
        self.jnd_alpha_base = jnd_alpha_base
        self.jnd_alpha_rand = jnd_alpha_rand

    def generate_random_watermark_fft(self) -> np.ndarray:
        raise NotImplementedError

    def _watermark_image(self, h: int, w: int, device) -> torch.Tensor:
        """(h, w, 3) pattern: one spectrum on every channel ('white') or one
        per channel, resized without antialias where it is not (h, w)."""
        if random.random() < 0.5:
            wm = np.repeat(self.generate_random_watermark_fft()[..., None], 3, axis=-1)
        else:
            wm = np.stack([self.generate_random_watermark_fft() for _ in range(3)], axis=-1)
        wm = torch.as_tensor(wm, device=device)
        if tuple(wm.shape[:2]) != (h, w):
            wm = resize_bilinear(wm, h, w, antialias=False)
        return wm

    def embed(self, imgs) -> dict:
        """imgs (N, H, W, 3) in [0, 1], a tensor or an array -> imgs_w,
        8-bit-quantised watermarked images on imgs' device."""
        out = []
        for img in torch.as_tensor(imgs):
            h, w = img.shape[:2]
            wm = self._watermark_image(h, w, img.device)
            if random.random() < 0.5:   # attenuated by the JND
                alpha = random.random() * self.jnd_alpha_rand + self.jnd_alpha_base
                img_w = self.jnd(img[None], torch.clamp(img + alpha * wm, 0, 1)[None])[0]
            else:   # the watermark everywhere
                alpha = random.random() * self.alpha_rand + self.alpha_base
                img_w = torch.clamp(img + alpha * wm, 0, 1)
            out.append(img_w)
        return {"imgs_w": torch.round(torch.stack(out) * 255.0) / 255.0}


class FFTWatermarkWaves(FFTWatermarkBase):
    """Sparse Fourier peaks: wave interference patterns."""

    def __init__(self):
        super().__init__(alpha_base=0.05, alpha_rand=0, jnd_alpha_base=0.5, jnd_alpha_rand=1.5)

    @staticmethod
    def generate_random_watermark_fft() -> np.ndarray:
        h = w = 512
        fwm = np.zeros((h, w), dtype=np.complex128)
        getv = lambda: random.randint(1_000_000, 10_000_000)  # noqa: E731
        max_ = random.randint(60, 200)

        def getr(m):
            radius = math.pow(random.randint(0, m), 0.8)
            angle = random.random() * math.pi / 2
            return round(math.sin(angle) * radius), round(math.cos(angle) * radius)

        for _ in range(random.randint(2, 50)):
            a, b = getr(max_)
            fwm[h // 2 - a, w // 2 - b] = getv() + getv() * 1j
        wm = np.real(np.fft.ifft2(np.fft.ifftshift(fwm))) / 5
        return np.float32(wm.clip(-255, 255) / 255)


class FFTWatermarkGaussian(FFTWatermarkBase):
    """A shaped random-noise spectrum."""

    def __init__(self):
        super().__init__(alpha_base=0.05, alpha_rand=0, jnd_alpha_base=1, jnd_alpha_rand=2)

    @staticmethod
    def generate_random_watermark_fft() -> np.ndarray:
        h = w = 512
        xc, yc = np.meshgrid(np.arange(h), np.arange(w))
        coords = np.stack([xc - w / 2, yc - h / 2], 2).reshape(-1, 2)
        power = 4 - math.sqrt(random.random()) * 3
        sigma = random.random() * 30 + 20
        quad = (np.abs(coords / sigma) ** power).sum(1) ** (1 / power)
        pd = np.exp(-quad / 2)
        fwm = np.zeros((h, w), dtype=np.complex128)
        fwm[yc.reshape(-1), xc.reshape(-1)] = (
            np.random.random(h * w) * pd / pd.max() * 1_000_000j)
        wm = np.real(np.fft.ifft2(np.fft.ifftshift(fwm))) / 5
        return np.float32(wm.clip(-255, 255) / 255)


class FFTWatermarkLines(FFTWatermarkBase):
    """Horizontal and vertical Fourier lines."""

    def __init__(self):
        super().__init__(alpha_base=0.1, alpha_rand=0.15, jnd_alpha_base=4, jnd_alpha_rand=4)

    @staticmethod
    def generate_random_watermark_fft() -> np.ndarray:
        def gauss(x, mu, sigma):
            return np.exp(-((x - mu) / sigma) ** 2 / 2) / (sigma * np.sqrt(2 * np.pi))

        h = w = 512
        fwm = np.zeros((h, w), dtype=np.complex128)
        sigma = random.random() * 35 + 5
        s1 = random.random() * 30 + 20
        s2 = random.random() * 30 + 20
        for c in np.round(np.abs(np.random.randn(random.randint(3, 10))) * sigma
                          ).astype(np.int32):
            fwm[h // 2 - c] = fwm[h // 2 + c] = (1.5 + np.random.random(w)) * gauss(c, 0, s1)
        for c in np.round(np.abs(np.random.randn(random.randint(3, 10))) * sigma
                          ).astype(np.int32):
            fwm[:, w // 2 - c] = fwm[:, w // 2 + c] = (1.5 + np.random.random(h)) * gauss(c, 0, s2)
        fwm = fwm / fwm.max() * 1_000_000j
        wm = np.real(np.fft.ifft2(np.fft.ifftshift(fwm))) / 5
        return np.float32(wm.clip(-255, 255) / 255)


_GENERATORS = {"waves": FFTWatermarkWaves, "gaussian": FFTWatermarkGaussian,
               "lines": FFTWatermarkLines}


def build_generator(name: str) -> FFTWatermarkBase:
    """A generator by name; "random" picks one with Python's `random`."""
    if name == "random":
        name = random.choice(list(_GENERATORS))
    return _GENERATORS[name]()
