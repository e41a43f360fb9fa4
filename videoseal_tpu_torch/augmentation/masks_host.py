"""Host-side LaMa-style watermark masks, counterpart of
``videoseal_tpu/augmentation/masks_host.py`` (a copy of its numpy code, so
that the port imports nothing of the JAX package): the reference's brush
stroke, rectangle, superres-grid and outpainting generators and the
MixedMaskEmbedder's mixing and inversion proportions, which set the
training distribution of localized watermarking. On the same
``np.random.Generator`` the masks are bit-equal to the JAX package's.

All generators return float32 masks shaped (1, H, W) and take `rng` for
determinism. Lines are drawn with cv2 where it imports (as in the JAX
package), else with a numpy stamp.

Provenance: the brush-stroke sampling sequence (0.01 + randint(max_angle),
alternating 2*pi - angle on even vertices, per-vertex length/width draws)
follows LaMa's public irregular-mask generator, which the reference itself
vendored (masks.py:45-149).
"""

from __future__ import annotations

import numpy as np


def _draw_line(mask, x0, y0, x1, y1, width):
    try:
        import cv2
        cv2.line(mask, (int(x0), int(y0)), (int(x1), int(y1)), 1.0, int(width))
        return
    except ImportError:
        pass
    # numpy fallback: sample points along the segment, stamp squares
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    r = max(int(width) // 2, 1)
    for t in np.linspace(0.0, 1.0, n):
        cx, cy = int(x0 + (x1 - x0) * t), int(y0 + (y1 - y0) * t)
        mask[max(cy - r, 0):cy + r, max(cx - r, 0):cx + r] = 1.0


def _draw_circle(mask, x, y, radius):
    try:
        import cv2
        cv2.circle(mask, (int(x), int(y)), radius=int(radius), color=1.0,
                   thickness=-1)
        return
    except ImportError:
        pass
    h, w = mask.shape
    ys, xs = np.ogrid[:h, :w]
    mask[(ys - y) ** 2 + (xs - x) ** 2 <= radius ** 2] = 1.0


def make_random_irregular_mask(shape, max_angle=4, max_len=60, max_width=20,
                               min_len=10, min_width=5, min_times=0,
                               max_times=10, draw_method="line",
                               rng: np.random.Generator | None = None):
    """Brush-stroke mask (masks.py:45-71): random walks of line/circle/square
    stamps with the reference's exact angle/length/width sampling."""
    rng = rng or np.random.default_rng()
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    times = int(rng.integers(min_times, max_times + 1))
    for i in range(times):
        start_x = int(rng.integers(width))
        start_y = int(rng.integers(height))
        for _ in range(1 + int(rng.integers(5))):
            angle = 0.01 + rng.integers(max_angle)
            if i % 2 == 0:
                angle = 2 * np.pi - angle
            length = min_len + rng.integers(max_len)
            brush_w = int(min_width + rng.integers(max_width))
            end_x = int(np.clip(start_x + length * np.sin(angle), 0, width))
            end_y = int(np.clip(start_y + length * np.cos(angle), 0, height))
            if draw_method == "line":
                _draw_line(mask, start_x, start_y, end_x, end_y, brush_w)
            elif draw_method == "circle":
                _draw_circle(mask, start_x, start_y, brush_w)
            elif draw_method == "square":
                r = brush_w // 2
                mask[max(start_y - r, 0):start_y + r,
                     max(start_x - r, 0):start_x + r] = 1.0
            start_x, start_y = end_x, end_y
    return mask[None, ...]


def make_random_rectangle_mask(shape, margin=10, bbox_min_size=30,
                               bbox_max_size=100, min_times=0, max_times=3,
                               no_overlap=False,
                               rng: np.random.Generator | None = None):
    """Union + per-rectangle masks (masks.py:98-149). Returns
    (union (1,H,W), individual (times,1,H,W))."""
    rng = rng or np.random.default_rng()
    height, width = shape
    union = np.zeros((height, width), np.float32)
    bbox_max_size = min(bbox_max_size, height - margin * 2, width - margin * 2)
    bbox_min_size = min(bbox_min_size, bbox_max_size)
    times = int(rng.integers(min_times, max_times + 1))
    individual = np.zeros((times, 1, height, width), np.float32)
    occupied = np.zeros((height, width), bool)
    for ii in range(times):
        for _ in range(100):
            bw = int(rng.integers(bbox_min_size, bbox_max_size + 1))
            bh = int(rng.integers(bbox_min_size, bbox_max_size + 1))
            sx = int(rng.integers(margin, max(width - margin - bw + 1, margin + 1)))
            sy = int(rng.integers(margin, max(height - margin - bh + 1, margin + 1)))
            if no_overlap and occupied[sy:sy + bh, sx:sx + bw].any():
                continue
            union[sy:sy + bh, sx:sx + bw] = 1.0
            individual[ii, 0, sy:sy + bh, sx:sx + bw] = 1.0
            occupied[sy:sy + bh, sx:sx + bw] = True
            break
    return union[None, ...], individual


def make_random_superres_mask(shape, min_step=2, max_step=4, min_width=1,
                              max_width=3, rng: np.random.Generator | None = None):
    """Periodic row/column grid (masks.py:152-165)."""
    rng = rng or np.random.default_rng()
    height, width = shape
    mask = np.zeros((height, width), np.float32)
    step_x = int(rng.integers(min_step, max_step + 1))
    width_x = int(rng.integers(min_width, min(step_x, max_width + 1)))
    offset_x = int(rng.integers(0, step_x))
    step_y = int(rng.integers(min_step, max_step + 1))
    width_y = int(rng.integers(min_width, min(step_y, max_width + 1)))
    offset_y = int(rng.integers(0, step_y))
    for dy in range(width_y):
        mask[offset_y + dy::step_y] = 1.0
    for dx in range(width_x):
        mask[:, offset_x + dx::step_x] = 1.0
    return mask[None, ...]


def make_outpainting_mask(shape, min_padding_percent=0.04,
                          max_padding_percent=0.25,
                          rng: np.random.Generator | None = None):
    """Border mask: ones outside a random inner box (masks.py:212-285)."""
    rng = rng or np.random.default_rng()
    height, width = shape
    mask = np.ones((height, width), np.float32)
    lo, hi = min_padding_percent, max_padding_percent
    t = int(height * rng.uniform(lo, hi))
    b = int(height * rng.uniform(lo, hi))
    l = int(width * rng.uniform(lo, hi))
    r = int(width * rng.uniform(lo, hi))
    mask[t:height - b, l:width - r] = 0.0
    return mask[None, ...]


def make_full_mask(shape, **_):
    return np.ones((1,) + tuple(shape), np.float32)


class MixedMaskEmbedder:
    """Sample a mask family by probability + optional inversion
    (masks.py:317-423). Default proportions match the reference:
    irregular 1/4, box 1/4, full 1/4, segmentation 1/4, invert 0.5."""

    def __init__(self, irregular_proba=1 / 4, irregular_kwargs=None,
                 box_proba=1 / 4, box_kwargs=None,
                 full_proba=1 / 4, full_kwargs=None,
                 squares_proba=0, squares_kwargs=None,
                 superres_proba=0, superres_kwargs=None,
                 outpainting_proba=0, outpainting_kwargs=None,
                 segm_proba=1 / 4, invert_proba=0.5, seed=None, **kwargs):
        self.rng = np.random.default_rng(seed)
        irregular_kwargs = dict(irregular_kwargs or {
            "max_angle": 4, "max_len": 50, "max_width": 20,
            "min_len": 50, "min_width": 20, "min_times": 1, "max_times": 5})
        irregular_kwargs["draw_method"] = "line"
        box_kwargs = dict(box_kwargs or {
            "margin": 10, "bbox_min_size": 30, "bbox_max_size": 100,
            "min_times": 1, "max_times": 3})
        squares_kwargs = dict(squares_kwargs or {
            "max_angle": 4, "max_len": 30, "max_width": 30,
            "min_len": 30, "min_width": 30, "min_times": 1, "max_times": 5})
        squares_kwargs["draw_method"] = "square"

        self.gens: list = [
            ("irregular", irregular_proba,
             lambda s: make_random_irregular_mask(s, rng=self.rng, **irregular_kwargs)),
            ("box", box_proba,
             lambda s: make_random_rectangle_mask(s, rng=self.rng, **box_kwargs)[0]),
            ("full", full_proba, make_full_mask),
            ("segm", segm_proba, None),  # dataset segmentation passthrough
        ]
        if squares_proba > 0:
            self.gens.append(("squares", squares_proba,
                              lambda s: make_random_irregular_mask(
                                  s, rng=self.rng, **squares_kwargs)))
        if superres_proba > 0:
            self.gens.append(("superres", superres_proba,
                              lambda s: make_random_superres_mask(
                                  s, rng=self.rng, **(superres_kwargs or {}))))
        if outpainting_proba > 0:
            self.gens.append(("outpaint", outpainting_proba,
                              lambda s: make_outpainting_mask(
                                  s, rng=self.rng, **(outpainting_kwargs or {}))))
        self.probas = np.array([p for _, p, _ in self.gens], np.float32)
        self.probas /= self.probas.sum()
        self.invert_proba = invert_proba

    def __call__(self, imgs, masks=None, **_):
        """imgs: (B, H, W, C) array-like; masks: optional dataset masks
        (B, H, W, 1). Returns (B, H, W, 1) float32."""
        imgs = np.asarray(imgs)
        b, h, w = imgs.shape[0], imgs.shape[-3], imgs.shape[-2]
        kind = int(self.rng.choice(len(self.gens), p=self.probas))
        name, _, gen = self.gens[kind]
        if name == "segm" and masks is not None:
            result = np.asarray(masks, np.float32)
        else:
            if gen is None:  # segm chosen but no dataset masks: full
                m = make_full_mask((h, w))
            else:
                m = gen((h, w))
            result = np.repeat(np.transpose(m, (1, 2, 0))[None], b, axis=0)
        if self.invert_proba > 0 and self.rng.random() < self.invert_proba \
                and result.shape[-1] == 1:
            result = 1.0 - result
        return result

    def sample_representative_masks(self, h: int, w: int):
        """Validation set: full, rect, ~rect, irregular, ~irregular
        (masks.py:411-423)."""
        rect = self.gens[1][2]((h, w))
        irregular = self.gens[0][2]((h, w))
        full = make_full_mask((h, w))
        return np.stack([full, rect, 1 - rect, irregular, 1 - irregular])


class NoMaskEmbedder:
    def __call__(self, imgs, masks=None, **_):
        imgs = np.asarray(imgs)
        return np.ones(imgs.shape[:1] + imgs.shape[-3:-1] + (1,), np.float32)


def get_mask_embedder(kind=None, **kwargs):
    """masks.py:426-438."""
    kind = kind or "mixed"
    if kind == "none":
        return NoMaskEmbedder()
    if kind == "mixed":
        return MixedMaskEmbedder(**kwargs)
    raise NotImplementedError(f"No such embedder kind = {kind}")
