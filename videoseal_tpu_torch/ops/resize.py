"""Separable bilinear resize with PyTorch/PIL-matching antialias semantics.

Counterpart of ``videoseal_tpu/ops/resize.py``. The resampling matrices are
built in numpy exactly as the JAX package builds them (bit-identical), and
the resize is two small dense matmuls, one per spatial axis, on NHWC tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) row-stochastic resampling matrix."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    support = scale if (antialias and scale > 1.0) else 1.0
    inv_scale = 1.0 / scale if (antialias and scale > 1.0) else 1.0

    dst = np.arange(out_size, dtype=np.float64)
    center = scale * (dst + 0.5)
    lo = np.maximum(0, np.floor(center - support + 0.5).astype(np.int64))
    hi = np.minimum(in_size, np.ceil(center + support + 0.5).astype(np.int64))
    max_taps = int((hi - lo).max())

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    taps = lo[:, None] + np.arange(max_taps)[None, :]          # (out, taps)
    t = (taps - center[:, None] + 0.5) * inv_scale
    w = np.maximum(0.0, 1.0 - np.abs(t))                       # triangle filter
    w[taps >= hi[:, None]] = 0.0
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    rows = np.repeat(np.arange(out_size), max_taps)
    cols = np.minimum(taps, in_size - 1).ravel()
    np.add.at(mat, (rows, cols), w.ravel())  # clamped pad taps carry weight 0
    return mat.astype(np.float32)


def resize_matrix(in_size: int, out_size: int, antialias: bool = True,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """`_resize_matrix` as a tensor of `dtype` on `device`."""
    return torch.as_tensor(_resize_matrix(in_size, out_size, antialias),
                           device=device).to(dtype)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    antialias: bool = True, precision: str = "highest",
                    out_dtype=None) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., out_h, out_w, C).

    precision="highest" computes in float32 (float64 input in float64);
    "default" runs both matmuls in bfloat16 (inputs and weight tables
    rounded to bf16, float32 accumulation, bf16 intermediate), the serving
    fast path. Integer inputs return float32 unless `out_dtype` says
    otherwise.
    """
    h, w = x.shape[-3], x.shape[-2]
    dt = out_dtype
    if dt is None:
        dt = x.dtype if x.is_floating_point() else torch.float32
    if (h, w) == (out_h, out_w):
        return x.to(dt)
    if precision == "highest":
        cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    elif precision == "default":
        cdt = torch.bfloat16
    else:
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    mh = resize_matrix(h, out_h, antialias, cdt, x.device)
    mw = resize_matrix(w, out_w, antialias, cdt, x.device)
    y = x.to(cdt)
    y = torch.einsum("Hh,...hwc->...Hwc", mh, y)
    y = torch.einsum("Ww,...hwc->...hWc", mw, y)
    return y.to(dt)


def resize_to(x: torch.Tensor, size: int | tuple[int, int],
              antialias: bool = True) -> torch.Tensor:
    """`resize_bilinear` to a square (int) or (h, w) size."""
    if isinstance(size, int):
        size = (size, size)
    return resize_bilinear(x, size[0], size[1], antialias=antialias)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour x`factor` upsample of (..., H, W, C)."""
    return x.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)


@functools.lru_cache(maxsize=64)
def _cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bicubic resampling matrix with torch's
    ``mode="bicubic"`` semantics (align_corners=False, no antialias): Keys'
    cubic kernel at a=-0.75, half-pixel centres, border taps clamped."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    a = -0.75
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    center = scale * (dst + 0.5) - 0.5
    base = np.floor(center).astype(np.int64)
    frac = center - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)

    def keys(t):
        t = np.abs(t)
        return np.where(
            t <= 1.0, ((a + 2) * t - (a + 3)) * t * t + 1,
            np.where(t < 2.0, (((t - 5) * t + 8) * t - 4) * a, 0.0))

    for k in range(-1, 3):
        w = keys(frac - k)
        cols = np.clip(base + k, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), cols), w)
    return mat.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize of (..., H, W, C) to (..., out_h, out_w, C) in float32,
    returned in x's dtype (DINOv2's position-embedding grid)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    mh = torch.as_tensor(_cubic_matrix(h, out_h), device=x.device)
    mw = torch.as_tensor(_cubic_matrix(w, out_w), device=x.device)
    y = torch.einsum("Hh,...hwc->...Hwc", mh, x.float())
    y = torch.einsum("Ww,...hwc->...hWc", mw, y)
    return y.to(x.dtype)


_PIL_BITS = 22      # Pillow's PRECISION_BITS for 8-bit images: 32 - 8 - 2


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter, Keys' kernel at a = -0.5."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=64)
def _pil_cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 matrix of Pillow's fixed-point bicubic
    coefficients (integers on the 2^22 scale), built as its
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` build them: the
    filter stretched by the downscale factor (antialiased), each row's
    weights normalised by their sum in order, then rounded half away from
    zero."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = _pil_bicubic((np.arange(xmin, xmax) - center + 0.5) * ss)
        ww = 0.0
        for v in w:             # Pillow sums in order
            ww += v
        if ww != 0.0:
            w = w / ww
        w = w * (1 << _PIL_BITS)
        mat[xx, xmin:xmax] = np.trunc(np.where(w < 0, w - 0.5, w + 0.5))
    return mat


def _pil_pass(y: torch.Tensor, mat: np.ndarray, eq: str) -> torch.Tensor:
    """One of Pillow's passes on integer-valued float64: the fixed-point
    sums (exact in float64), + 2^21, shifted down, clipped to u8."""
    k = torch.as_tensor(mat, device=y.device)
    y = torch.einsum(eq, k, y)
    return torch.clamp(torch.floor((y + (1 << (_PIL_BITS - 1))) / (1 << _PIL_BITS)), 0, 255)


def resize_bicubic_pil(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize u8 (..., H, W, C) to (..., out_h, out_w, C) as Pillow's
    ``Image.resize((out_w, out_h))`` does at its default filter (bicubic,
    a = -0.5, antialiased): the horizontal pass first into u8, then the
    vertical one, each in Pillow's 22-bit fixed point, on x's device. The
    integer sums are exact in float64, so the result is Pillow's to the
    last bit wherever its coefficients are."""
    h, w = x.shape[-3], x.shape[-2]
    y = x.to(torch.float64)
    if w != out_w:
        y = _pil_pass(y, _pil_cubic_matrix(w, out_w), "Ww,...hwc->...hWc")
    if h != out_h:
        y = _pil_pass(y, _pil_cubic_matrix(h, out_h), "Hh,...hwc->...Hwc")
    return y.to(torch.uint8)
