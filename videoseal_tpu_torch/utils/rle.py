"""COCO segmentations to masks without pycocotools, counterpart of
``videoseal_tpu/utils/rle.py``: polygons (rasterised with cv2),
uncompressed RLE (a list of counts) and compressed RLE (COCO's LEB128-like
string). Masks are (h, w) uint8 in {0, 1}."""

from __future__ import annotations

import numpy as np


def decode_compressed_rle(counts: str | bytes, h: int, w: int) -> np.ndarray:
    """A COCO compressed RLE string -> (h, w) uint8 mask. Each count is
    5-bit groups offset by 48, 0x20 marking a continuation and 0x10 the
    sign of the last group; from the third count on, each is stored as the
    difference to the count two before it."""
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    nums: list[int] = []
    i = 0
    while i < len(counts):
        x, k, more = 0, 0, True
        while more:
            c = counts[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(nums) > 2:
            x += nums[-2]
        nums.append(x)
    return _runs_to_mask(nums, h, w)


def _runs_to_mask(counts: list[int], h: int, w: int) -> np.ndarray:
    """Alternating runs of 0 and 1, column-major (COCO's order)."""
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (a list of polygons, or an RLE dict with
    list or string counts) -> (h, w) uint8 mask."""
    if isinstance(seg, list):
        import cv2
        mask = np.zeros((h, w), np.uint8)
        for poly in seg:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return mask
    if isinstance(seg, dict):
        counts = seg["counts"]
        sh, sw = seg.get("size", (h, w))
        if isinstance(counts, list):
            return _runs_to_mask(counts, sh, sw)
        return decode_compressed_rle(counts, sh, sw)
    raise TypeError(f"unsupported segmentation {type(seg)}")
