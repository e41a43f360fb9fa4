"""Bilinear resampling matrices and the separable resize of NHWC tensors, in
float32 (float64 input stays float64).

The matrix is PyTorch's and PIL's bilinear filter with antialias: a
triangle of support max(1, in/out) around each output pixel's centre,
each row normalised to sum to one, taps beyond the border dropped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def resize_matrix_np(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) row-stochastic float64 resampling matrix."""
    if in_size == out_size:
        return np.eye(in_size)
    scale = in_size / out_size
    wide = antialias and scale > 1.0
    support = scale if wide else 1.0
    inv = 1.0 / scale if wide else 1.0
    mat = np.zeros((out_size, in_size))
    for o in range(out_size):
        centre = scale * (o + 0.5)
        lo = max(0, int(np.floor(centre - support + 0.5)))
        hi = min(in_size, int(np.ceil(centre + support + 0.5)))
        taps = np.arange(lo, hi)
        wts = np.maximum(0.0, 1.0 - np.abs((taps - centre + 0.5) * inv))
        mat[o, lo:hi] = wts / max(wts.sum(), 1e-12)
    return mat


def resize_matrix(in_size: int, out_size: int, antialias: bool, like: torch.Tensor
                  ) -> torch.Tensor:
    dt = torch.float64 if like.dtype == torch.float64 else torch.float32
    return torch.as_tensor(resize_matrix_np(in_size, out_size, antialias), dtype=dt,
                           device=like.device)


def resize(x: torch.Tensor, out_h: int, out_w: int, antialias: bool = True) -> torch.Tensor:
    """(..., H, W, C) float -> (..., out_h, out_w, C), height then width."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    y = torch.einsum("Hh,...hwc->...Hwc", resize_matrix(h, out_h, antialias, x), x)
    return torch.einsum("Ww,...hwc->...hWc", resize_matrix(w, out_w, antialias, x), y)
