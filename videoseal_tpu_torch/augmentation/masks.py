"""On-device watermark-mask samplers, counterpart of
``videoseal_tpu/augmentation/masks.py``.

Families:
  none / full -> all ones
  rect        -> 1..4 random axis-aligned rectangles
  blob        -> thresholded smoothed noise (irregular blobs)
  outpaint    -> the border region (an inverted center rectangle)
  mixed       -> one of {full, rect, blob, outpaint} per item
  segmentation-> the dataset's masks pass through
plus an invert probability. Draws come from an explicit ``torch.Generator``
and are read on the host; the rasters are built on the images' device. The
``*_from`` functions take the draws, so a test can hold them against the
JAX package's at the same draws.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .augs import uniform

_F32 = np.float32


def _coord_grids(h: int, w: int, device):
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


def rect_from(h: int, w: int, frac_h: float, frac_w: float, u_top: float, u_left: float,
              device=None) -> torch.Tensor:
    """(h, w) rectangle mask: frac_h and frac_w of the canvas, its corner at
    u_top and u_left of the room left (float32, the JAX package's order)."""
    rh, rw = _F32(frac_h) * _F32(h), _F32(frac_w) * _F32(w)
    top, left = _F32(u_top) * (_F32(h) - rh), _F32(u_left) * (_F32(w) - rw)
    ys, xs = _coord_grids(h, w, device)
    inside = ((ys >= float(top)) & (ys < float(top + rh))
              & (xs >= float(left)) & (xs < float(left + rw)))
    return inside.float()


def _rect(g, h, w, device, min_frac=0.2, max_frac=0.8) -> torch.Tensor:
    return rect_from(h, w, uniform(g, min_frac, max_frac), uniform(g, min_frac, max_frac),
                     uniform(g, 0.0, 1.0), uniform(g, 0.0, 1.0), device)


def _rects(g, h, w, device) -> torch.Tensor:
    n = int(torch.randint(1, 5, (), generator=g, device=g.device))
    m = torch.zeros((h, w), device=device)
    for _ in range(n):
        m = torch.maximum(m, _rect(g, h, w, device))
    return m


@functools.lru_cache(maxsize=64)
def keys_cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) weights of ``jax.image.resize(..., "bicubic")``:
    Keys' cubic with a = -0.5 at half-pixel centers, the taps outside the
    input dropped and each column renormalised, in float32 as JAX computes
    them. (``F.interpolate``'s bicubic uses a = -0.75 and clamps instead.)"""
    inv_scale = _F32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, _F32(1.0))
    sample_f = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv_scale - _F32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / kernel_scale
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= 1.0, ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x + _F32(2.0), out)
    weights = np.where(x >= 2.0, _F32(0.0), out).astype(_F32)
    total = weights.sum(axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, _F32(0.0)).astype(_F32)


def blob_from(coarse: torch.Tensor, thr: float, h: int, w: int,
              sharpness: float = 12.0) -> torch.Tensor:
    """Blob mask from (ch, cw) coarse noise, upsampled with JAX's bicubic
    weights (two matmuls) and thresholded at thr."""
    mh = torch.as_tensor(keys_cubic_matrix(coarse.shape[0], h), device=coarse.device)
    mw = torch.as_tensor(keys_cubic_matrix(coarse.shape[1], w), device=coarse.device)
    up = mh.T @ coarse.float() @ mw
    return torch.sigmoid(sharpness * (up - thr)).round()


def _blob(g, h, w, device) -> torch.Tensor:
    coarse = torch.randn((max(h // 32, 2), max(w // 32, 2)), generator=g, device=g.device)
    return blob_from(coarse.to(device), uniform(g, -0.5, 0.8), h, w)


def _outpaint(g, h, w, device) -> torch.Tensor:
    return 1.0 - _rect(g, h, w, device, min_frac=0.4, max_frac=0.9)


def _ones(g, h, w, device) -> torch.Tensor:
    return torch.ones((h, w), device=device)


_FAMILIES = {"rect": _rects, "blob": _blob, "outpaint": _outpaint}
_MIXED = (_ones, _rects, _blob, _outpaint)


def build_mask_sampler(cfg: dict):
    """sampler(generator, imgs_w, masks, rows=None, mesh=None) -> (B, H, W, 1)
    float mask, from cfg = {'kind': none|full|rect|blob|outpaint|mixed|
    segmentation, 'invert_proba': p}. 'segmentation' passes the dataset's
    masks through (all ones without them). On a `mesh` (imgs_w a rank's
    rows, at the global indices `rows`) the masks are drawn for the global
    batch and the rank's rows returned, so every rank draws the same
    numbers."""
    kind = cfg.get("kind", None)
    kind = None if kind in (None, "none", "None") else str(kind)
    invert_p = float(cfg.get("invert_proba", 0.0))

    def ones(generator, imgs_w, masks, rows=None, mesh=None):
        return torch.ones_like(imgs_w[..., 0:1])

    if kind is None or kind == "full":
        return ones
    if kind not in (*_FAMILIES, "mixed", "segmentation"):
        raise ValueError(f"mask kind {kind!r}")

    def sampler(generator, imgs_w, masks, rows=None, mesh=None):
        if kind == "segmentation":
            return masks if masks is not None else ones(generator, imgs_w, masks)
        b, h, w = imgs_w.shape[0], imgs_w.shape[-3], imgs_w.shape[-2]
        if rows is not None:
            full = sampler(generator, imgs_w.new_empty((b * mesh.world, h, w, 1)), None)
            return full[rows.to(full.device)]
        dev = imgs_w.device
        ms = []
        for _ in range(b):
            if kind == "mixed":
                fam = _MIXED[int(torch.randint(0, 4, (), generator=generator,
                                               device=generator.device))]
            else:
                fam = _FAMILIES[kind]
            ms.append(fam(generator, h, w, dev))
        ms = torch.stack(ms)
        if invert_p > 0:
            inv = (torch.rand((b, 1, 1), generator=generator, device=generator.device)
                   < invert_p).to(dev)
            ms = torch.where(inv, 1.0 - ms, ms)
        return ms[..., None]

    return sampler


def sample_representative_masks(generator: torch.Generator, h: int, w: int,
                                device=None) -> torch.Tensor:
    """The fixed validation set: one full, rect, blob and outpaint mask,
    (4, H, W, 1)."""
    zeros = torch.zeros((1, h, w, 1), device=device)
    return torch.cat([build_mask_sampler({"kind": k})(generator, zeros, None)
                      for k in ("full", "rect", "blob", "outpaint")], dim=0)
