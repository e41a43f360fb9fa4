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

    precision="highest" computes in float32; "default" runs both matmuls in
    bfloat16 (inputs and weight tables rounded to bf16, float32 accumulation,
    bf16 intermediate), the serving fast path. Integer inputs return float32
    unless `out_dtype` says otherwise.
    """
    h, w = x.shape[-3], x.shape[-2]
    dt = out_dtype
    if dt is None:
        dt = x.dtype if x.is_floating_point() else torch.float32
    if (h, w) == (out_h, out_w):
        return x.to(dt)
    if precision == "highest":
        cdt = torch.float32
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
