"""LPIPS and the VGG-feature perceptual distances, counterpart of
``videoseal_tpu/losses/lpips.py``: the `lpips` package's forward (net "vgg",
the training loss, or "alex", the eval column; normalize=False, so the
scaling layer sees the raw [0, 1] input), the reference's Watson-VGG, and
DISTS (whose VGG16 replaces the max-pools with Hanning L2 pooling).

Inputs are NHWC images in [0, 1]; the modules run NCHW inside. The weights
are the JAX package's converted ``.npz`` files (flax trees: HWIO conv
kernels, the heads' vectors) under ``weights_dir`` or
``$VIDEOSEAL_TPU_WEIGHTS``; none ships with the repository, and `build`
raises ``FileNotFoundError`` naming the file when it is absent, as the JAX
package's does. The loss's own parameters take no gradient; its input does.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# lpips/watson scaling-layer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv plan: (channels, convs in the stage); the taps are each stage's
# last relu: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_VGG_CHANNELS = [64, 128, 256, 512, 512]
# AlexNet: (channels, kernel, stride, pad, max-pool before)
_ALEX_PLAN = [(64, 11, 4, 2, False), (192, 5, 1, 2, True), (384, 3, 1, 1, True),
              (256, 3, 1, 1, False), (256, 3, 1, 1, False)]


def _channel_affine(x: torch.Tensor, shift, scale) -> torch.Tensor:
    """(x - shift) / scale per channel of NCHW x."""
    s = torch.tensor(shift, dtype=x.dtype, device=x.device)[None, :, None, None]
    k = torch.tensor(scale, dtype=x.dtype, device=x.device)[None, :, None, None]
    return (x - s) / k


def _l2pool(v: torch.Tensor, filter_size: int = 5, stride: int = 2) -> torch.Tensor:
    """Hanning-window L2 pooling of NCHW v: sqrt(depthwise conv(v^2, g))."""
    a = np.hanning(filter_size)[1:-1]
    g = (a[:, None] * a[None, :]).astype(np.float32)
    g /= g.sum()
    c = v.shape[1]
    k = torch.as_tensor(g, dtype=v.dtype, device=v.device)[None, None].expand(c, 1, *g.shape)
    out = F.conv2d(v * v, k, stride=stride, padding=(filter_size - 2) // 2, groups=c)
    return torch.sqrt(out + 1e-12)


class VGG16Features(nn.Module):
    """VGG16's five taps. pool "max" is torchvision's graph (lpips,
    watson_vgg); "l2" is DISTS' L2-pooled variant."""

    def __init__(self, pool: str = "max"):
        super().__init__()
        self.pool = pool
        cin = 3
        for si, (ch, n) in enumerate(_VGG_PLAN):
            for ci in range(n):
                self.add_module(f"conv{si}_{ci}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x):
        feats = []
        for si, (_, n) in enumerate(_VGG_PLAN):
            for ci in range(n):
                x = F.relu(getattr(self, f"conv{si}_{ci}")(x))
            feats.append(x)
            if si < len(_VGG_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2) if self.pool == "max" else _l2pool(x)
        return feats


class AlexFeatures(nn.Module):
    """AlexNet's taps after each of its five relus (the eval-time LPIPS)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, s, p, _) in enumerate(_ALEX_PLAN):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, k, stride=s, padding=p))
            cin = ch

    def forward(self, x):
        feats = []
        for i, (_, _, _, _, mp) in enumerate(_ALEX_PLAN):
            if mp:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return feats


def _unit_norm(t: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Euclidean normalisation over the channels of NCHW t."""
    return t / (torch.sqrt(torch.sum(t * t, dim=1, keepdim=True)) + eps)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class LPIPS(nn.Module):
    """The lpips package's forward: scaling layer, backbone taps, unit
    normalisation, squared difference, the 1x1 linear heads, spatial mean.
    (B,) per image pair."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        self.net = net
        if net == "vgg":
            self.vgg = VGG16Features()
            chans = _VGG_CHANNELS
        else:
            self.alex = AlexFeatures()
            chans = [p[0] for p in _ALEX_PLAN]
        for i, c in enumerate(chans):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))

    def forward(self, x, y):
        x = _channel_affine(_nchw(x), _SHIFT, _SCALE)
        y = _channel_affine(_nchw(y), _SHIFT, _SCALE)
        backbone = self.vgg if self.net == "vgg" else self.alex
        total = 0.0
        for i, (a, b) in enumerate(zip(backbone(x), backbone(y))):
            d = (_unit_norm(a) - _unit_norm(b)) ** 2
            w = getattr(self, f"lin{i}")[None, :, None, None]
            total = total + torch.mean(torch.sum(w * d, dim=1), dim=(-2, -1))
        return total


def _soft_max_mix(a, b, factor: float = 1.0):
    m = torch.softmax(torch.stack([a, b], -1) * factor, dim=-1)
    return a * m[..., 0] + b * m[..., 1]


class WatsonDistanceVgg(nn.Module):
    """Watson distance over VGG16 features, called as (input, target): the
    contrast masking uses the target's features."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        self.beta = nn.Parameter(torch.ones(()))
        for i, c in enumerate(_VGG_CHANNELS):
            self.register_parameter(f"t{i}_tild", nn.Parameter(torch.zeros(c)))
            self.register_parameter(f"w{i}_tild",
                                    nn.Parameter(torch.full((), float(np.log(0.2 / 0.8)))))

    def forward(self, x, y):
        eps = 1e-10
        c1 = self.vgg(_channel_affine(_nchw(x), _SHIFT, _SCALE))   # input
        c0 = self.vgg(_channel_affine(_nchw(y), _SHIFT, _SCALE))   # target
        beta = self.beta
        total = 0.0
        for i in range(len(_VGG_CHANNELS)):
            t = torch.exp(getattr(self, f"t{i}_tild"))[None, :, None, None]
            w = torch.sigmoid(getattr(self, f"w{i}_tild"))
            a = _unit_norm(c0[i], eps)
            b = _unit_norm(c1[i], eps)
            s = _soft_max_mix(t.expand_as(a), (torch.abs(a) + eps) ** w * t ** (1 - w))
            hw = a.shape[-2] * a.shape[-1]
            layer = (torch.abs((a - b) / s) + eps) ** beta + eps
            total = total + torch.sum(layer, dim=(-3, -2, -1)) / hw
        return total ** (1 / beta)


class DISTS(nn.Module):
    """Structure and texture similarity over the L2-pooled VGG16 stages:
    per-channel alpha and beta weights normalised by their joint sum."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features(pool="l2")
        n = 3 + sum(_VGG_CHANNELS)
        self.alpha = nn.Parameter(torch.ones(n))
        self.beta = nn.Parameter(torch.ones(n))

    def forward(self, x, y):
        mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
        x, y = _nchw(x), _nchw(y)
        fx = [x] + self.vgg(_channel_affine(x, mean, std))
        fy = [y] + self.vgg(_channel_affine(y, mean, std))
        chans = [3] + _VGG_CHANNELS
        w_sum = self.alpha.sum() + self.beta.sum()
        alphas = torch.split(self.alpha / w_sum, chans)
        betas = torch.split(self.beta / w_sum, chans)
        c1 = c2 = 1e-6
        dist1 = dist2 = 0.0
        for k in range(len(chans)):
            a, b = fx[k], fy[k]
            mu_a, mu_b = a.mean(dim=(-2, -1)), b.mean(dim=(-2, -1))
            var_a = a.var(dim=(-2, -1), correction=0)
            var_b = b.var(dim=(-2, -1), correction=0)
            cov = (a * b).mean(dim=(-2, -1)) - mu_a * mu_b
            s1 = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
            s2 = (2 * cov + c2) / (var_a + var_b + c2)
            dist1 = dist1 + torch.sum(alphas[k] * s1, dim=-1)
            dist2 = dist2 + torch.sum(betas[k] * s2, dim=-1)
        return 1 - (dist1 + dist2)


WEIGHT_FILES = {"lpips": "lpips_vgg.npz", "lpips_alex": "lpips_alex.npz",
                "watson_vgg": "watson_vgg.npz", "dists": "dists.npz"}
_MODULES = {"lpips": LPIPS, "lpips_alex": lambda: LPIPS(net="alex"),
            "watson_vgg": WatsonDistanceVgg, "dists": DISTS}


def state_dict_from_flax(params: dict) -> dict:
    """A flax parameter tree of these modules -> their state dict: the
    paths joined with '.', conv kernels HWIO -> OIHW as 'weight'."""
    sd = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            elif k == "kernel":
                sd[f"{prefix}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(np.transpose(np.asarray(v, np.float32), (3, 2, 0, 1))))
            else:
                sd[path] = torch.from_numpy(np.array(v, np.float32))

    walk(params, "")
    return sd


def load(name: str, path: str) -> nn.Module:
    """The loss module `name` with the converted weights at `path`, frozen."""
    from ..utils.checkpoint import unflatten_tree

    with np.load(path) as data:
        params = unflatten_tree({k: data[k] for k in data.files})
    mod = _MODULES[name]()
    mod.load_state_dict(state_dict_from_flax(params))
    return mod.requires_grad_(False).eval()


_cache: dict[tuple, nn.Module] = {}


def build(name: str, weights_dir: str | None = None):
    """(x, y) -> mean distance of loss `name` over NHWC images in [0, 1],
    with the weights file of `WEIGHT_FILES` under `weights_dir` (or
    ``$VIDEOSEAL_TPU_WEIGHTS``); the module follows the input's device."""
    if name not in _MODULES:
        raise NotImplementedError(
            f"{name}: use lpips/watson_vgg/dists or a non-VGG loss "
            f"(yuv/mse/ssim/msssim/focal/jnd/watson_dft)")
    weights_dir = weights_dir or os.environ.get("VIDEOSEAL_TPU_WEIGHTS", "")
    path = os.path.join(weights_dir, WEIGHT_FILES[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{name} needs converted weights at {path}: the VGG16/AlexNet weights and "
            f"the loss's trained parameters, converted offline by "
            f"`python -m videoseal_tpu_torch.tools.convert_lpips`")

    def fn(x, y):
        key = (path, x.device)
        if key not in _cache:
            _cache[key] = load(name, path).to(x.device)
        return torch.mean(_cache[key](x, y))

    return fn
