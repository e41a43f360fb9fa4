"""Differentiable JPEG proxy, counterpart of ``videoseal_tpu/ops/jpeg.py``.

RGB -> full-range YCbCr -> 8x8 block DCT -> divide by the quality-scaled
ITU-T.81 tables -> round with a straight-through gradient -> dequantize ->
inverse DCT -> RGB, with optional 2x2 chroma averaging (``subsample``). The
tables are scaled on the host in float32 as libjpeg does. The DCT's two
8-point transforms are written as explicit float32 multiply-adds over the
block axes, not as matmuls: they run in true float32 on any device whatever
the TF32 settings, and in the same order on the card and on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ITU-T.81 Annex K base quantization tables (public standard)
_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)

_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float32)


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """8x8 orthonormal DCT-II matrix."""
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m[0] *= 1 / np.sqrt(2)
    return (m * 0.5).astype(np.float32)


def scaled_table(base: np.ndarray, quality) -> np.ndarray:
    """libjpeg's quality scaling (jcparam.c) of a base table, in float32."""
    q = np.float32(np.clip(float(quality), 1, 100))
    scale = np.float32(5000.0) / q if q < 50 else np.float32(200.0) - np.float32(2.0) * q
    t = np.floor((base * scale + np.float32(50.0)) / np.float32(100.0))
    return np.clip(t, 1.0, 255.0).astype(np.float32)


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, with the identity as its gradient."""
    return x + (torch.round(x) - x).detach()


def _transform(x: torch.Tensor, m: np.ndarray, dim: int) -> torch.Tensor:
    """out_i = sum_k m[i, k] * x_k along `dim` (size 8), k in order."""
    cols = x.unbind(dim)
    rows = []
    for i in range(8):
        acc = cols[0] * float(m[i, 0])
        for k in range(1, 8):
            acc = acc + cols[k] * float(m[i, k])
        rows.append(acc)
    return torch.stack(rows, dim)


def _plane_roundtrip(plane: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """DCT-quantize-dequantize one (..., H, W) plane (values centered at 0)."""
    *lead, h, w = plane.shape
    d = _dct_matrix()
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8)          # (.., bh, j, bw, k)
    coef = _transform(_transform(x, d, -1), d, -3)           # D B D^T
    t = torch.as_tensor(table, device=plane.device).reshape(8, 1, 8)
    q = _ste_round(coef / t) * t
    rec = _transform(_transform(q, d.T, -1), d.T, -3)        # D^T Q D
    return rec.reshape(*lead, h, w)


def _down2(p: torch.Tensor) -> torch.Tensor:
    """2x2 mean of a (..., H, W) plane, the four taps summed in a fixed order."""
    return (((p[..., 0::2, 0::2] + p[..., 0::2, 1::2]) + p[..., 1::2, 0::2])
            + p[..., 1::2, 1::2]) / 4.0


def _up2(p: torch.Tensor) -> torch.Tensor:
    return p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def jpeg_roundtrip(img: torch.Tensor, quality, subsample: bool = False) -> torch.Tensor:
    """Differentiable JPEG round trip of (..., H, W, 3) in [0, 1].

    H and W must be multiples of 8, and of 16 with `subsample` (its
    half-size chroma planes are blocked 8x8 too); otherwise ValueError. The
    JAX package's proxy fails at the same sizes (a 1080-row frame with
    `subsample` gives 540 chroma rows)."""
    h, w = img.shape[-3], img.shape[-2]
    m = 16 if subsample else 8
    if h % m or w % m:
        what = "its half-size chroma planes" if subsample else "its planes"
        raise ValueError(f"jpeg_roundtrip: a {h}x{w} frame cannot be blocked 8x8: {what} "
                         f"must be multiples of 8, so H and W multiples of {m}")
    x = torch.clamp(img, 0.0, 1.0) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    # full-range YCbCr (JFIF)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b

    ty, tc = scaled_table(_Q_LUMA, quality), scaled_table(_Q_CHROMA, quality)
    y = _plane_roundtrip(y - 128.0, ty) + 128.0
    if subsample:
        cb = _up2(_plane_roundtrip(_down2(cb), tc))
        cr = _up2(_plane_roundtrip(_down2(cr), tc))
    else:
        cb = _plane_roundtrip(cb, tc)
        cr = _plane_roundtrip(cr, tc)

    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    out = torch.stack([r, g, b], dim=-1) / 255.0
    return torch.clamp(out, 0.0, 1.0)
