"""Watson perceptual distance in block-FFT space, counterpart of
``videoseal_tpu/losses/watson_fft.py``.

Per 8x8 block real-FFT amplitudes with luminance and contrast masking and a
trainable quantization matrix, applied per YCbCr channel and summed (the
reference's colour wrapper). Parameters default to the reference's init
(uniform QM, alpha 0.1, w 0.2, beta 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch

EPS = 1e-10


def _block_rfft2(x: torch.Tensor, blocksize: int = 8) -> torch.Tensor:
    """(N, H, W) -> (N, K, b, b//2+1) complex block rFFT / b^2."""
    n, h, w = x.shape
    b = blocksize
    blocks = x.reshape(n, h // b, b, w // b, b).transpose(2, 3).reshape(n, -1, b, b)
    return torch.fft.rfft2(blocks) / (b * b)


def _softmax_mix(a, b, factor: float = 1.0):
    """Smooth max of two tensors."""
    m = torch.softmax(torch.stack([a, b], dim=-1) * factor, dim=-1)
    return a * m[..., 0] + b * m[..., 1]


@dataclasses.dataclass
class WatsonDistanceFft:
    """Functional form; the params dict uses the reference's state_dict
    names."""
    blocksize: int = 8

    def init_params(self, device=None) -> dict:
        b = self.blocksize
        ws = (b, b // 2 + 1)
        w = 0.2
        return {
            "t_tild": torch.zeros(ws, device=device),
            "alpha": torch.tensor(0.1, device=device),
            "w_tild": torch.tensor(math.log(w / (1 - w)), device=device),
            "beta": torch.tensor(1.0, device=device),
            "w_phase_tild": torch.zeros(ws, device=device) - 2.0,
        }

    def __call__(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (N, H, W) single-channel; returns the per-item distance (N,)."""
        b = self.blocksize
        ws1 = b // 2 + 1
        c0 = _block_rfft2(y, b)
        c1 = _block_rfft2(x, b)

        t = torch.exp(params["t_tild"])
        w = torch.sigmoid(params["w_tild"])
        beta = params["beta"]
        w_phase = torch.exp(params["w_phase_tild"])
        # the real-only coefficients carry no phase
        mask = torch.ones_like(w_phase)
        for (i, j) in [(0, 0), (0, ws1 - 1), (ws1 - 1, ws1 - 1), (ws1 - 1, 0)]:
            mask[i, j] = 0.0
        w_phase = w_phase * mask

        c0_amp = torch.sqrt(c0.real ** 2 + c0.imag ** 2 + EPS ** 2)
        c1_amp = torch.sqrt(c1.real ** 2 + c1.imag ** 2 + EPS ** 2)

        avg_lum = torch.mean(c0_amp[:, :, 0, 0])
        t_l = t[None, None] * (((c0_amp[:, :, 0, 0] + EPS) / (avg_lum + EPS))
                               ** params["alpha"])[:, :, None, None]
        s = _softmax_mix(t_l, (torch.abs(c0_amp) + EPS) ** w * t_l ** (1 - w))

        watson = (torch.abs((c0_amp - c1_amp) / s) + EPS) ** beta
        watson = torch.sum(watson + EPS, dim=(1, 2, 3)) ** (1 / beta)

        p0 = torch.atan2(c0.imag, c0.real + EPS)
        p1 = torch.atan2(c1.imag, c1.real + EPS)
        phase = torch.arccos(torch.cos(p0 - p1) * (1 - EPS * 1e3)) * w_phase
        return watson + torch.sum(phase, dim=(1, 2, 3))


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def watson_fft_distance(x: torch.Tensor, y: torch.Tensor,
                        params_per_channel: list[dict] | None = None) -> torch.Tensor:
    """Colour-wrapped Watson-FFT distance of (N, H, W, 3) images in [0, 1]:
    the per-YCbCr-channel distances, summed."""
    dist = WatsonDistanceFft()
    if params_per_channel is None:
        params_per_channel = [dist.init_params(x.device)] * 3
    xc, yc = rgb_to_ycbcr(x), rgb_to_ycbcr(y)
    total = 0.0
    for c in range(3):
        total = total + dist(params_per_channel[c], xc[..., c], yc[..., c])
    return total


def watson_fft_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean Watson-FFT distance at the default-init params ("watson_dft")."""
    return torch.mean(watson_fft_distance(x, y))
