"""Discriminators for GAN training, counterpart of
``videoseal_tpu/modules/discriminator.py``. NHWC images in, NHWC logits out;
NCHW inside.

* ``NLayerDiscriminator``: the PatchGAN of the training recipe (4x4 convs,
  GroupNorm(4), LeakyReLU 0.2; ``input_nc=1`` scores the Y channel).
* ``ActNorm``: per-channel affine whose first call in train mode sets loc and
  scale from that batch's statistics (the reference's data-dependent init).
* ``UNetDiscriminatorSN``: the Real-ESRGAN U-Net with spectral-normalised
  convs, unused by the default recipe. ``SNConv2d`` is flax's
  ``nn.SpectralNorm`` (one power iteration from the stored ``u``, the weight
  divided by sigma; ``u`` and ``sigma`` stored only with update_stats, i.e.
  in train mode), not ``torch.nn.utils.spectral_norm``, which updates in
  place on every train-mode call and keeps ``v`` too.

Module names follow the JAX package's parameter trees (``conv0``,
``norm1``, ``conv_out``), so ``utils/convert.disc_from_jax`` is a transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.color import rgb_to_yuv
from ..ops.resize import resize_bilinear


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class NLayerDiscriminator(nn.Module):
    """PatchGAN over NHWC input in [0, 1]-ish."""

    def __init__(self, input_nc: int = 3, ndf: int = 32, n_layers: int = 3):
        super().__init__()
        self.input_nc = input_nc
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1)
        nf_prev = 1
        for n in range(1, n_layers + 1):
            nf = min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv{n}", nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride=stride,
                                                  padding=1))
            self.add_module(f"norm{n}", nn.GroupNorm(4, ndf * nf, eps=1e-5))
            nf_prev = nf
        self.conv_out = nn.Conv2d(ndf * nf_prev, 1, 4, padding=1)

    def forward(self, x):
        if self.input_nc == 1 and x.shape[-1] == 3:
            x = rgb_to_yuv(x)[..., 0:1]
        x = _lrelu(self.conv0(x.permute(0, 3, 1, 2)))
        for n in range(1, self.n_layers + 1):
            x = _lrelu(getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(x)))
        return self.conv_out(x).permute(0, 2, 3, 1)


class ActNorm(nn.Module):
    """scale * (x + loc) per channel of NHWC x. The first call in train mode
    sets loc = -mean and scale = 1 / (std + 1e-6) over every axis but the
    channels."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(num_features))
        self.scale = nn.Parameter(torch.ones(num_features))
        self.register_buffer("initialized", torch.tensor(0, dtype=torch.uint8))

    def forward(self, x):
        if self.training and not bool(self.initialized):
            dims = tuple(range(x.ndim - 1))
            with torch.no_grad():
                self.loc.copy_(-x.mean(dim=dims))
                self.scale.copy_(1.0 / (x.std(dim=dims, correction=0) + 1e-6))
                self.initialized.fill_(1)
        return self.scale * (x + self.loc)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's "SAME" padding of NCHW x for a k x k kernel at stride s."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SNConv2d(nn.Module):
    """A bias-free conv ("SAME" padding) whose weight is divided by its
    spectral norm, estimated by one power iteration from the stored `u`;
    `u` (1, O) and `sigma` () are stored only when update_stats."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.register_buffer("u", torch.randn(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, x, update_stats: bool = False):
        w = self.weight
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])     # flax's (k*k*I, O)
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.T)
            u = _l2_normalize(v @ mat)
        sigma = (v @ mat @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        return F.conv2d(_same_pad(x, self.k, self.stride), w, stride=self.stride)


class UNetDiscriminatorSN(nn.Module):
    """U-Net discriminator (Real-ESRGAN), spectral norm on conv1-conv8."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3)
        self.conv1 = SNConv2d(nf, nf * 2, 4, 2)
        self.conv2 = SNConv2d(nf * 2, nf * 4, 4, 2)
        self.conv3 = SNConv2d(nf * 4, nf * 8, 4, 2)
        self.conv4 = SNConv2d(nf * 8, nf * 4, 3)
        self.conv5 = SNConv2d(nf * 4, nf * 2, 3)
        self.conv6 = SNConv2d(nf * 2, nf, 3)
        self.conv7 = SNConv2d(nf, nf, 3)
        self.conv8 = SNConv2d(nf, nf, 3)
        self.conv9 = nn.Conv2d(nf, 1, 3)

    def forward(self, x, train: bool = False):
        def up2(t):
            y = resize_bilinear(t.permute(0, 2, 3, 1), t.shape[-2] * 2, t.shape[-1] * 2,
                                antialias=False)
            return y.permute(0, 3, 1, 2)

        sn = lambda conv, t: _lrelu(conv(t, update_stats=train))
        x0 = _lrelu(self.conv0(_same_pad(x.permute(0, 3, 1, 2), 3, 1)))
        x1 = sn(self.conv1, x0)
        x2 = sn(self.conv2, x1)
        x3 = sn(self.conv3, x2)
        x4 = sn(self.conv4, up2(x3))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = sn(self.conv5, up2(x4))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = sn(self.conv6, up2(x5))
        if self.skip_connection:
            x6 = x6 + x0
        out = sn(self.conv8, sn(self.conv7, x6))
        return self.conv9(_same_pad(out, 3, 1)).permute(0, 2, 3, 1)
