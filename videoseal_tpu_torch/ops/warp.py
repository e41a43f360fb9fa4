"""Geometric warp primitives, counterpart of ``videoseal_tpu/ops/warp.py``.

One gather-based bilinear sampler (zero fill outside, differentiable in the
image) serves rotate, perspective and crop-resize on (..., H, W, C) tensors.
The warp's parameters (the inverse affine matrix, the homography) are small
and are computed on the host in float32, in the JAX package's operation
order; the sampling grid and the gather run on the image's device with
elementwise float32 operations only, so the card and the CPU give the same
result.
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import resize_bilinear

_F32 = np.float32


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample (..., H, W, C) `img` at float pixel coordinates xs, ys (Ho, Wo);
    taps outside the image read 0. Returns (..., Ho, Wo, C)."""
    h, w, c = img.shape[-3], img.shape[-2], img.shape[-1]
    lead = tuple(img.shape[:-3])
    x0, y0 = torch.floor(xs), torch.floor(ys)
    tx, ty = (xs - x0)[..., None], (ys - y0)[..., None]
    # a tap further out than one pixel reads 0 either way: clamping before the
    # integer conversion keeps far-out (or infinite) coordinates in range
    x0i = x0.clamp(-2, w + 1).long()
    y0i = y0.clamp(-2, h + 1).long()
    flat = img.reshape(lead + (h * w, c))

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1)
        vals = flat.index_select(-2, idx).reshape(lead + tuple(xs.shape) + (c,))
        return vals * valid[..., None].to(img.dtype)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return (1 - ty) * ((1 - tx) * v00 + tx * v01) + ty * ((1 - tx) * v10 + tx * v11)


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return xs, ys


def warp_affine_inverse(img: torch.Tensor, inv) -> torch.Tensor:
    """Warp with the INVERSE 2x3 affine matrix `inv` (output -> input
    coordinates), float32 values on the host."""
    h, w = img.shape[-3], img.shape[-2]
    xs, ys = _grid(h, w, img.device)
    (a, b, c), (d, e, f) = [[float(v) for v in row] for row in np.asarray(inv, _F32)]
    return bilinear_sample(img, a * xs + b * ys + c, d * xs + e * ys + f)


def rotation_inverse(h: int, w: int, angle_deg: float) -> np.ndarray:
    """The inverse 2x3 matrix of a rotation by angle_deg about the center,
    in float32 in the JAX package's operation order."""
    a = _F32(-_F32(angle_deg)) * _F32(np.pi / 180.0)
    ca, sa = np.cos(a), np.sin(a)
    cx, cy = _F32((w - 1) / 2.0), _F32((h - 1) / 2.0)
    return np.array([[ca, -sa, cx - ca * cx + sa * cy],
                     [sa, ca, cy - sa * cx - ca * cy]], _F32)


def rotate(img: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """Rotate about the center, bilinear, fill 0, same canvas (torchvision
    ``F.rotate`` with bilinear interpolation, counterclockwise for +deg)."""
    return warp_affine_inverse(img, rotation_inverse(img.shape[-3], img.shape[-2], angle_deg))


def solve_homography(src, dst) -> np.ndarray:
    """The 8-dof homography (3x3 float32) mapping 4 points `src` to `dst`
    ((4, 2) each): torchvision's 8x8 system, solved in float32 on the host."""
    src, dst = np.asarray(src, _F32), np.asarray(dst, _F32)
    rows, rhs = [], []
    for (sx, sy), (dx, dy) in zip(src, dst):
        rows.append([sx, sy, 1, 0, 0, 0, -dx * sx, -dx * sy])
        rows.append([0, 0, 0, sx, sy, 1, -dy * sx, -dy * sy])
        rhs.extend([dx, dy])
    a = torch.as_tensor(np.array(rows, _F32))
    b = torch.as_tensor(np.array(rhs, _F32))
    coeffs = torch.linalg.solve(a, b).numpy()
    return np.concatenate([coeffs, np.ones(1, _F32)]).reshape(3, 3)


def warp_perspective(img: torch.Tensor, startpoints, endpoints) -> torch.Tensor:
    """torchvision ``F.perspective``: the output pixel at an end point reads
    the input at its start point (the input sampled at H(end -> start))."""
    hm = [[float(v) for v in row] for row in solve_homography(endpoints, startpoints)]
    h, w = img.shape[-3], img.shape[-2]
    xs, ys = _grid(h, w, img.device)
    denom = hm[2][0] * xs + hm[2][1] * ys + hm[2][2]
    xi = (hm[0][0] * xs + hm[0][1] * ys + hm[0][2]) / denom
    yi = (hm[1][0] * xs + hm[1][1] * ys + hm[1][2]) / denom
    return bilinear_sample(img, xi, yi)


def crop_resize(img: torch.Tensor, top: int, left: int, crop_h: int, crop_w: int) -> torch.Tensor:
    """Crop a (crop_h, crop_w) window at (top, left) and resample it to the
    full canvas (half-pixel centers): the static-shape form of a crop."""
    h, w = img.shape[-3], img.shape[-2]
    xs, ys = _grid(h, w, img.device)
    sx, sy = float(_F32(crop_w) / _F32(w)), float(_F32(crop_h) / _F32(h))
    return bilinear_sample(img, (xs + 0.5) * sx - 0.5 + int(left),
                           (ys + 0.5) * sy - 0.5 + int(top))


def resize_area_scale(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize to (out_h, out_w) and back to the canvas: the information loss
    of a rescale at a fixed shape."""
    h, w = img.shape[-3], img.shape[-2]
    return resize_bilinear(resize_bilinear(img, out_h, out_w), h, w)
