"""Quality and robustness metrics, counterpart of ``videoseal_tpu/ops/metrics.py``.

Images are (..., H, W, C) in [0, 1]; message predictions are (B, K)
whole-image logits or (B, H, W, K) pixelwise logits, as in the JAX package.
The functions run on the tensors' device; the binomial p-value and the
Bjontegaard rate run on the host (scipy), as in the JAX package. SSIM is the
unclamped pytorch_msssim form: it can exceed 1 exactly where the JAX
package's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


# -- image quality ------------------------------------------------------------------

def psnr(x, y, is_video: bool = False) -> torch.Tensor:
    """PSNR in dB over [0, 1] images (on 255-scaled deltas); video mode
    averages the MSE over all frames."""
    x, y = _f32(x), _f32(y)
    delta = 255.0 * (x - y)
    delta = delta.reshape((-1,) + tuple(x.shape[-3:]))
    peak = 20 * math.log10(255.0)
    dims = (0, 1, 2, 3) if is_video else (1, 2, 3)
    noise = (delta ** 2).mean(dim=dims)
    return peak - 10 * torch.log10(noise)


def linf(x, y, data_range: float = 1.0) -> torch.Tensor:
    """L_inf in 0-255 pixel space."""
    return (_f32(x) - _f32(y)).abs().max() * (255.0 / data_range)


def _fspecial_gauss_1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode gaussian blur of (B, H, W, C), depthwise, along H
    then W."""
    c, k = x.shape[-1], win.shape[0]
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    y = F.conv2d(y, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return y.permute(0, 2, 3, 1)


def _ssim_components(x, y, data_range=1.0, win_size=11, win_sigma=1.5, k1=0.01, k2=0.03):
    """Per-channel SSIM and contrast-structure means, (B, C) each."""
    win = torch.as_tensor(_fspecial_gauss_1d(win_size, win_sigma), device=x.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _gaussian_filter(x, win)
    mu2 = _gaussian_filter(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gaussian_filter(x * x, win) - mu1_sq
    sigma2_sq = _gaussian_filter(y * y, win) - mu2_sq
    sigma12 = _gaussian_filter(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2)), cs_map.mean(dim=(1, 2))


def ssim(x, y, data_range: float = 1.0) -> torch.Tensor:
    """Per-image SSIM (pytorch_msssim.ssim), unclamped."""
    s, _ = _ssim_components(_f32(x), _f32(y), data_range)
    return s.mean(dim=-1)


def _avg_pool2_torch(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(x, 2, padding=shape % 2) on NHWC: zero pad on both sides,
    the zeros counted in the mean."""
    ph, pw = x.shape[1] % 2, x.shape[2] % 2
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, padding=(ph, pw), count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def ms_ssim(x, y, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM (pytorch_msssim.ms_ssim)."""
    x, y = _f32(x), _f32(y)
    weights = torch.tensor([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], device=x.device)
    levels = weights.shape[0]
    mcs = []
    for i in range(levels):
        s, cs = _ssim_components(x, y, data_range)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            x = _avg_pool2_torch(x)
            y = _avg_pool2_torch(y)
    s = torch.relu(s)
    mcs_and_ssim = torch.stack(mcs + [s], dim=0)          # (levels, B, C)
    val = torch.prod(mcs_and_ssim ** weights[:, None, None], dim=0)
    return val.mean(dim=-1)


# -- detection and decoding ---------------------------------------------------------

def iou(preds, targets, threshold: float = 0.0, label: int = 1) -> torch.Tensor:
    """IoU of (B, H, W, 1) mask logits against targets."""
    p = torch.as_tensor(preds) > threshold
    t = torch.as_tensor(targets) > 0.5
    if label == 0:
        p, t = ~p, ~t
    inter = (p & t).sum(dim=(1, 2, 3)).float()
    union = (p | t).sum(dim=(1, 2, 3)).float()
    return torch.where(union == 0, torch.ones_like(union), inter / union.clamp(min=1.0))


def accuracy(preds, targets, threshold: float = 0.0) -> torch.Tensor:
    """Pixel accuracy of (B, H, W, 1) mask logits."""
    p = torch.as_tensor(preds) > threshold
    t = torch.as_tensor(targets) > 0.5
    return (p == t).float().mean(dim=(1, 2, 3))


def bit_accuracy(preds, targets, mask=None, threshold: float = 0.0) -> torch.Tensor:
    """Fraction of correctly decoded bits per item. preds (B, K) logits or
    (B, H, W, K) pixelwise logits; targets (B, K) bits; mask optional
    (B, H, W, 1) for the pixelwise case (any nonzero pixel is selected; an
    empty mask gives NaN, which a nanmean skips)."""
    p = torch.as_tensor(preds) > threshold
    empty = None
    if p.dim() == 4:
        if mask is not None:
            m = (torch.as_tensor(mask) > 0).float()
            num = (p.float() * m).sum(dim=(1, 2))
            den = m.sum(dim=(1, 2))
            p = (num / den.clamp(min=1e-8)) > 0.5
            empty = m.sum(dim=(1, 2, 3)) == 0
        else:
            p = p.float().mean(dim=(1, 2)) > 0.5
    t = torch.as_tensor(targets) > 0.5
    acc = (p == t).float().mean(dim=-1)
    if empty is not None:
        acc = torch.where(empty, torch.full_like(acc, float("nan")), acc)
    return acc


def bit_accuracy_1msg(preds, targets, masks=None, threshold: float = 0.0) -> torch.Tensor:
    """Per-pixel bit accuracy averaged over pixels. preds (B, H, W, K)
    pixelwise logits; targets (B, K)."""
    preds = torch.as_tensor(preds)
    p = preds > threshold
    t = (torch.as_tensor(targets) > 0.5)[:, None, None, :]
    correct = (p == t).float()
    if masks is not None:
        masks = torch.as_tensor(masks)
        m = (masks > 0.5).float()
        num = (correct * m).sum(dim=(1, 2, 3))
        den = (m.sum(dim=(1, 2, 3)) * preds.shape[-1] / masks.shape[-1]).clamp(min=1e-8)
        return num / den
    return correct.mean(dim=(1, 2, 3))


def bit_accuracy_inference(preds, targets, masks, method: str = "hard",
                           threshold: float = 0.0) -> torch.Tensor:
    """Pixels -> message -> accuracy. hard: binarise each pixel, then the
    masked mean; semihard: the masked mean of the logits; soft: the
    mask-weighted mean of the logits."""
    preds, masks = torch.as_tensor(preds), torch.as_tensor(masks)
    m = masks if method == "soft" else (masks > 0.5).to(preds.dtype)
    x = (preds > threshold).to(preds.dtype) if method == "hard" else preds
    num = (x * m).sum(dim=(1, 2))
    den = m.sum(dim=(1, 2)).clamp(min=1e-8)
    msg = (num / den) > 0.5
    t = torch.as_tensor(targets) > 0.5
    return (msg == t).float().mean(dim=-1)


def bit_accuracy_mv(preds, targets, masks=None, threshold: float = 0.0) -> torch.Tensor:
    """Majority vote over pixels, bit by bit."""
    p = (torch.as_tensor(preds) > threshold).float()
    if masks is not None:
        m = (torch.as_tensor(masks) > 0.5).float()
        frac = (p * m).sum(dim=(1, 2)) / m.sum(dim=(1, 2)).clamp(min=1e-8)
    else:
        frac = p.mean(dim=(1, 2))
    t = torch.as_tensor(targets) > 0.5
    return ((frac > 0.5) == t).float().mean(dim=-1)


def bd_rate(r1, psnr1, r2, psnr2, piecewise: int = 0) -> float:
    """Bjontegaard delta rate, in percent (host, numpy and scipy)."""
    from scipy import interpolate

    lr1, lr2 = np.log(r1), np.log(r2)
    p1 = np.polyfit(psnr1, lr1, 3)
    p2 = np.polyfit(psnr2, lr2, 3)
    min_int = max(min(psnr1), min(psnr2))
    max_int = min(max(psnr1), max(psnr2))
    if piecewise == 0:
        pi1, pi2 = np.polyint(p1), np.polyint(p2)
        int1 = np.polyval(pi1, max_int) - np.polyval(pi1, min_int)
        int2 = np.polyval(pi2, max_int) - np.polyval(pi2, min_int)
    else:
        samples, interval = np.linspace(min_int, max_int, num=100, retstep=True)
        psnr1, psnr2 = np.asarray(psnr1), np.asarray(psnr2)
        v1 = interpolate.pchip_interpolate(np.sort(psnr1), lr1[np.argsort(psnr1)], samples)
        v2 = interpolate.pchip_interpolate(np.sort(psnr2), lr2[np.argsort(psnr2)], samples)
        trapz = getattr(np, "trapezoid", getattr(np, "trapz", None))
        int1 = trapz(v1, dx=interval)
        int2 = trapz(v2, dx=interval)
    avg_exp_diff = (int2 - int1) / (max_int - min_int)
    return float((np.exp(avg_exp_diff) - 1) * 100)


def pvalue(bit_accs, nbits: int) -> np.ndarray:
    """One-sided binomial test p-value of each bit accuracy (host, scipy)."""
    from scipy import stats

    accs = np.atleast_1d(np.asarray(torch.as_tensor(bit_accs).detach().cpu()))
    return np.array([stats.binomtest(int(round(float(a) * nbits)), nbits, 0.5,
                                     alternative="greater").pvalue for a in accs])


def capacity(bit_accs, nbits: int) -> torch.Tensor:
    """Binary-symmetric-channel capacity in bits."""
    p = _f32(bit_accs).clamp(0.0, 1.0)

    def plogp(q):
        return torch.where(q > 0, q * torch.log2(q.clamp(min=1e-30)), torch.zeros_like(q))

    entropy = -plogp(p) - plogp(1 - p)
    return nbits * (1 - entropy)
