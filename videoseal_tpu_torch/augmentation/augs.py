"""Differentiable augmentations (the attack simulator), counterpart of
``videoseal_tpu/augmentation/augs.py``.

Every aug is a small dataclass over (..., H, W, C) float tensors with:

* ``sample(generator, img) -> params``: draw its parameters from its range
  with an explicit ``torch.Generator`` (the JAX package takes a key);
* ``transform(img, mask, params) -> (img, mask)``: apply them;
* ``apply(generator, img, mask)``: the two in turn (the training path);
* ``apply_strength(img, mask, strength)``: apply at a fixed strength (the
  evaluation grids, where shapes may change).

Parameters are drawn on the generator's device and read on the host; the
transforms run on the image's device. Codec attacks carry gradients: the
JPEG proxy by a straight-through round (``ops/jpeg.py``), the exact codec by
an identity backward around the host round trip.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import warp as W
from ..ops.jpeg import jpeg_roundtrip
from ..ops.resize import resize_bilinear

# the eight uniforms the JAX package's Perspective.apply_strength draws from
# jax.random.split(jax.random.PRNGKey(0), 8): fixed numbers, whatever the
# image or the strength (tests/test_torch_augs.py recomputes them with JAX)
PERSPECTIVE_EVAL_DRAWS = (0.8423141241073608, 0.007293820381164551, 0.9024494886398315,
                          0.26698946952819824, 0.1536543369293213, 0.7380603551864624,
                          0.8776865005493164, 0.4750462770462036)


def uniform(g: torch.Generator, lo: float, hi: float) -> float:
    """A float in [lo, hi) from the generator."""
    return float(torch.rand((), generator=g, device=g.device)) * (hi - lo) + lo


def _randint(g: torch.Generator, lo: int, hi: int) -> int:
    """An integer in [lo, hi)."""
    return int(torch.randint(lo, hi, (), generator=g, device=g.device))


def _bernoulli(g: torch.Generator, p: float, n: int) -> torch.Tensor:
    return (torch.rand((n,), generator=g, device=g.device) < p).cpu()


def eval_generator() -> torch.Generator:
    """The generator of the eval draws that depend on the shape
    (GaussianNoise, TemporalReorder, DropFrame): the CPU's, seeded 0, where
    the JAX package draws from PRNGKey(0)."""
    return torch.Generator().manual_seed(0)


class Aug:
    """`couples_samples`: the transform mixes batch entries (frames), so
    under data parallelism it runs on the gathered global batch;
    `shard_params` takes a rank's rows of parameters drawn for the global
    batch (``Augmenter.__call__`` with a mesh)."""
    name = "aug"
    couples_samples = False

    def sample(self, generator: torch.Generator, img: torch.Tensor):
        return None

    def shard_params(self, params, rows: torch.Tensor):
        return params

    def transform(self, img, mask, params):
        raise NotImplementedError

    def apply(self, generator: torch.Generator, img, mask):
        return self.transform(img, mask, self.sample(generator, img))

    def apply_strength(self, img, mask, strength):
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


@dataclasses.dataclass
class Identity(Aug):
    name = "identity"

    def transform(self, img, mask, params=None):
        return img, mask

    def apply_strength(self, img, mask, strength=None):
        return img, mask


# -- geometric --------------------------------------------------------------------------

def _rot90(x: torch.Tensor, k: int) -> torch.Tensor:
    """Counterclockwise by k * 90 degrees (jnp.rot90 over the H, W axes)."""
    return torch.rot90(x, k, dims=(-3, -2)) if k % 4 else x


@dataclasses.dataclass
class Rotate(Aug):
    """Small-angle rotation, optionally composed with a +-90 base rotation."""
    min_angle: float = -10
    max_angle: float = 10
    do90: bool = False
    name = "rotate"

    def sample(self, generator, img):
        angle = uniform(generator, self.min_angle, self.max_angle)
        return angle, (_randint(generator, 0, 4) if self.do90 else 1)

    def transform(self, img, mask, params):
        angle, k90 = params
        img, mask = W.rotate(img, angle), W.rotate(mask, angle)
        if self.do90:
            if img.shape[-3] != img.shape[-2]:
                raise ValueError("do90 rotation on the training path needs square frames")
            k = (3, 0, 0, 1)[k90]   # [-90, 0, 0, +90]
            img, mask = _rot90(img, k), _rot90(mask, k)
        return img, mask

    def apply_strength(self, img, mask, strength):
        angle = np.float32(strength)
        base = (int(strength) // 90) * 90
        if base % 360 != 0:
            k = (base // 90) % 4
            img, mask = _rot90(img, k), _rot90(mask, k)
        rem = float(angle - np.float32(base))
        return W.rotate(img, rem), W.rotate(mask, rem)


@dataclasses.dataclass
class Resize(Aug):
    """Area rescale (information loss); the training path picks a scale
    from a discrete bank and keeps the canvas."""
    min_size: float = 0.7
    max_size: float = 1.5
    n_scales: int = 8
    name = "resize"

    def sample(self, generator, img):
        return _randint(generator, 0, self.n_scales)

    def transform(self, img, mask, params):
        s = np.linspace(self.min_size, self.max_size, self.n_scales)[params]
        h, w = img.shape[-3], img.shape[-2]
        oh, ow = max(8, int(round(h * s))), max(8, int(round(w * s)))
        return W.resize_area_scale(img, oh, ow), W.resize_area_scale(mask, oh, ow)

    def apply_strength(self, img, mask, strength):
        h, w = img.shape[-3], img.shape[-2]
        oh, ow = int(strength * h), int(strength * w)
        return resize_bilinear(img, oh, ow), resize_bilinear(mask, oh, ow)


@dataclasses.dataclass
class Crop(Aug):
    min_size: float = 0.5
    max_size: float = 1.0
    name = "crop"

    def sample(self, generator, img):
        h, w = img.shape[-3], img.shape[-2]
        ch = _randint(generator, int(self.min_size * h), int(self.max_size * h) + 1)
        cw = _randint(generator, int(self.min_size * w), int(self.max_size * w) + 1)
        top = _randint(generator, 0, h + 1) % max(h - ch + 1, 1)
        left = _randint(generator, 0, w + 1) % max(w - cw + 1, 1)
        return top, left, ch, cw

    def transform(self, img, mask, params):
        return W.crop_resize(img, *params), W.crop_resize(mask, *params)

    def apply_strength(self, img, mask, strength):
        # a center crop of a strength-scaled window (the shape changes)
        h, w = img.shape[-3], img.shape[-2]
        ch, cw = int(strength * h), int(strength * w)
        top, left = (h - ch) // 2, (w - cw) // 2
        return (img[..., top:top + ch, left:left + cw, :],
                mask[..., top:top + ch, left:left + cw, :])


def perspective_points(h: int, w: int, d: float, u) -> tuple[np.ndarray, np.ndarray]:
    """(start, end) corners of a perspective warp of distortion d from the
    eight uniforms u, in float32 in the JAX package's operation order."""
    f = np.float32
    dx, dy = f(d) * f(w // 2), f(d) * f(h // 2)
    u = [f(v) for v in u]
    end = np.array([[u[0] * dx, u[1] * dy],
                    [f(w - 1) - u[2] * dx, u[3] * dy],
                    [f(w - 1) - u[4] * dx, f(h - 1) - u[5] * dy],
                    [u[6] * dx, f(h - 1) - u[7] * dy]], f)
    start = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], f)
    return start, end


@dataclasses.dataclass
class Perspective(Aug):
    min_distortion_scale: float = 0.1
    max_distortion_scale: float = 0.5
    name = "perspective"

    def sample(self, generator, img):
        d = uniform(generator, self.min_distortion_scale, self.max_distortion_scale)
        return d, [uniform(generator, 0.0, 1.0) for _ in range(8)]

    def transform(self, img, mask, params):
        start, end = perspective_points(img.shape[-3], img.shape[-2], *params)
        return W.warp_perspective(img, start, end), W.warp_perspective(mask, start, end)

    def apply_strength(self, img, mask, strength):
        return self.transform(img, mask, (strength, PERSPECTIVE_EVAL_DRAWS))


@dataclasses.dataclass
class HorizontalFlip(Aug):
    name = "hflip"

    def transform(self, img, mask, params=None):
        return torch.flip(img, (-2,)), torch.flip(mask, (-2,))

    def apply_strength(self, img, mask, strength=None):
        return self.transform(img, mask)


# -- valuemetric ------------------------------------------------------------------------

def _blend_clamp(a, b, f):
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def _luma(img):
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


@dataclasses.dataclass
class _Factor(Aug):
    """An aug whose one parameter is a factor drawn from [min, max)."""
    min_factor: float = 0.5
    max_factor: float = 2.0

    def sample(self, generator, img):
        return uniform(generator, self.min_factor, self.max_factor)

    def transform(self, img, mask, params):
        return self.apply_strength(img, mask, params)


@dataclasses.dataclass
class Brightness(_Factor):
    name = "brightness"

    def apply_strength(self, img, mask, strength):
        return _blend_clamp(img, torch.zeros_like(img), strength), mask


@dataclasses.dataclass
class Contrast(_Factor):
    name = "contrast"

    def apply_strength(self, img, mask, strength):
        # torchvision adjust_contrast: blend with the mean of the grayscale
        mean = _luma(img).mean(dim=(-3, -2, -1), keepdim=True)
        return _blend_clamp(img, mean, strength), mask


@dataclasses.dataclass
class Saturation(_Factor):
    name = "saturation"

    def apply_strength(self, img, mask, strength):
        return _blend_clamp(img, _luma(img), strength), mask


@dataclasses.dataclass
class Hue(_Factor):
    min_factor: float = -0.1
    max_factor: float = 0.1
    name = "hue"

    def apply_strength(self, img, mask, strength):
        # rotate the hue in HSV space by `strength` turns (adjust_hue)
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        maxc = torch.maximum(torch.maximum(r, g), b)
        minc = torch.minimum(torch.minimum(r, g), b)
        v = maxc
        c = maxc - minc
        zero = torch.zeros_like(v)
        s = torch.where(v > 0, c / torch.clamp(v, min=1e-12), zero)
        safe_c = torch.clamp(c, min=1e-12)
        hr = torch.remainder((g - b) / safe_c, 6.0)
        hg = (b - r) / safe_c + 2.0
        hb = (r - g) / safe_c + 4.0
        h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)) / 6.0
        h = torch.where(c > 0, h, zero)
        h = torch.remainder(h + strength, 1.0)
        # hsv -> rgb
        i = torch.floor(h * 6.0)
        f = h * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - f * s)
        t = v * (1 - (1 - f) * s)
        i = torch.remainder(i.to(torch.int32), 6)

        def select(*vals):
            out = vals[5]
            for j in (4, 3, 2, 1, 0):
                out = torch.where(i == j, vals[j], out)
            return out

        return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                            select(p, p, t, v, v, q)], dim=-1), mask


def _reflect_pad(img: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad the H and W axes of (..., H, W, C) by p (numpy 'reflect':
    the edge pixel is not repeated)."""
    def index(n):
        i = np.abs(np.arange(-p, n + p))
        return torch.as_tensor(np.where(i > n - 1, 2 * (n - 1) - i, i), device=img.device)
    return img.index_select(-3, index(img.shape[-3])).index_select(-2, index(img.shape[-2]))


def _odd_sizes(lo: int, hi: int) -> list[int]:
    return sorted({k | 1 for k in range(lo, hi + 1)})


@dataclasses.dataclass
class GaussianBlur(Aug):
    min_kernel_size: int = 3
    max_kernel_size: int = 17
    name = "gaussian_blur"

    @staticmethod
    def taps(k: int) -> np.ndarray:
        """The normalised float32 taps of an odd k (torchvision's sigma)."""
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
        x = np.arange(k, dtype=np.float32) - (k - 1) / 2
        g = np.exp(-(x ** 2) / (2 * sigma ** 2))
        return g / g.sum()

    def _blur(self, img: torch.Tensor, k: int) -> torch.Tensor:
        """Reflect pad, then a separable depthwise convolution (along H, then
        W) as k shifted float32 multiply-adds each: no TF32 on the card."""
        k = int(k) | 1
        g = [float(v) for v in self.taps(k)]
        h, w = img.shape[-3], img.shape[-2]
        y = _reflect_pad(img, k // 2)
        for size, dim in ((h, -3), (w, -2)):
            acc = g[0] * y.narrow(dim, 0, size)
            for i in range(1, k):
                acc = acc + g[i] * y.narrow(dim, i, size)
            y = acc
        return y

    def sample(self, generator, img):
        sizes = _odd_sizes(self.min_kernel_size, self.max_kernel_size)
        return sizes[_randint(generator, 0, len(sizes))]

    def transform(self, img, mask, params):
        return self._blur(img, params), mask

    def apply_strength(self, img, mask, strength):
        return self._blur(img, int(strength)), mask


@dataclasses.dataclass
class MedianFilter(Aug):
    min_kernel_size: int = 3
    max_kernel_size: int = 3
    passthrough: bool = True
    name = "median_filter"

    def _median(self, img: torch.Tensor, k: int) -> torch.Tensor:
        k = int(k) | 1
        p = _reflect_pad(img, k // 2)
        h, w = img.shape[-3], img.shape[-2]
        patches = [p[..., i:i + h, j:j + w, :] for i in range(k) for j in range(k)]
        med = torch.stack(patches, dim=0).median(dim=0).values
        if self.passthrough:   # straight-through: the gradient of the identity
            med = img + (med - img).detach()
        return med

    def sample(self, generator, img):
        sizes = _odd_sizes(self.min_kernel_size, self.max_kernel_size)
        return sizes[_randint(generator, 0, len(sizes))]

    def transform(self, img, mask, params):
        return self._median(img, params), mask

    def apply_strength(self, img, mask, strength):
        return self._median(img, int(strength)), mask


@dataclasses.dataclass
class GaussianNoise(Aug):
    min_std: float = 0.0
    max_std: float = 0.1
    name = "gaussian_noise"

    def sample(self, generator, img):
        std = uniform(generator, self.min_std, self.max_std)
        return std, torch.randn(tuple(img.shape), generator=generator, device=generator.device)

    def transform(self, img, mask, params):
        std, noise = params
        return img + std * noise.to(img.device, img.dtype), mask

    def shard_params(self, params, rows: torch.Tensor):
        std, noise = params
        return std, noise[rows.to(noise.device)]

    def apply_strength(self, img, mask, strength):
        noise = torch.randn(tuple(img.shape), generator=eval_generator())
        return self.transform(img, mask, (strength, noise))


@dataclasses.dataclass
class Grayscale(Aug):
    name = "grayscale"

    def transform(self, img, mask, params=None):
        return _luma(img).expand(img.shape), mask

    def apply_strength(self, img, mask, strength=None):
        return self.transform(img, mask)


# -- codec attacks ----------------------------------------------------------------------

@dataclasses.dataclass
class JPEG(Aug):
    min_quality: int = 40
    max_quality: int = 80
    name = "jpeg"

    def sample(self, generator, img):
        return _randint(generator, self.min_quality, self.max_quality + 1)

    def transform(self, img, mask, params):
        return jpeg_roundtrip(img, params), mask

    def apply_strength(self, img, mask, strength):
        return jpeg_roundtrip(img, strength), mask


# -- temporal ---------------------------------------------------------------------------

def _take(x: torch.Tensor, idx) -> torch.Tensor:
    return x.index_select(0, torch.as_tensor(np.asarray(idx, np.int64), device=x.device))


@dataclasses.dataclass
class SpeedChange(Aug):
    """Temporal resample to a new speed at the same frame count (nearest
    frame)."""
    min_speed: float = 0.5
    max_speed: float = 2.0
    couples_samples = True
    name = "speed_change"

    def sample(self, generator, img):
        return uniform(generator, self.min_speed, self.max_speed)

    def transform(self, img, mask, params):
        return self.apply_strength(img, mask, params)

    def apply_strength(self, img, mask, strength):
        f = img.shape[0]
        idx = np.clip((np.arange(f, dtype=np.float32) * np.float32(strength)).astype(np.int32),
                      0, f - 1)
        return _take(img, idx), _take(mask, idx)


@dataclasses.dataclass
class TemporalReorder(Aug):
    """Swap adjacent frame pairs, each with some probability."""
    chunk_size: int = 4
    swap_probability: float = 0.5
    couples_samples = True
    name = "temporal_reorder"

    def sample(self, generator, img):
        return _bernoulli(generator, self.swap_probability, img.shape[0] // 2)

    def transform(self, img, mask, params):
        swap = np.asarray(params, bool)
        f, half = img.shape[0], img.shape[0] // 2
        perm = np.arange(f)
        even, odd = perm[:2 * half:2].copy(), perm[1:2 * half:2].copy()
        perm[:2 * half:2] = np.where(swap, odd, even)
        perm[1:2 * half:2] = np.where(swap, even, odd)
        return _take(img, perm), _take(mask, perm)

    def apply_strength(self, img, mask, strength):
        p = strength[1] if isinstance(strength, tuple) else strength
        return self.transform(img, mask, _bernoulli(eval_generator(), p, img.shape[0] // 2))


@dataclasses.dataclass
class WindowAveraging(Aug):
    """Sliding-window temporal blend."""
    window_size: int = 3
    alpha: float = 1.0
    couples_samples = True
    name = "window_averaging"

    def transform(self, img, mask, params=None):
        return self.apply_strength(img, mask, (self.window_size, self.alpha))

    def apply_strength(self, img, mask, strength):
        ws, alpha = strength if isinstance(strength, tuple) else (int(strength), self.alpha)
        ws, f = int(ws), img.shape[0]
        acc = torch.zeros_like(img)
        for d in range(-(ws // 2), ws // 2 + 1):
            acc = acc + _take(img, np.clip(np.arange(f) + d, 0, f - 1))
        return alpha * (acc / ws) + (1 - alpha) * img, mask


@dataclasses.dataclass
class DropFrame(Aug):
    """Replace random frames with their left neighbour."""
    min_prob: float = 0.2
    max_prob: float = 0.5
    couples_samples = True
    name = "drop_frame"

    def sample(self, generator, img):
        p = uniform(generator, self.min_prob, self.max_prob)
        return _bernoulli(generator, p, img.shape[0])

    def transform(self, img, mask, params):
        drop = np.asarray(params, bool).copy()
        drop[0] = False   # the first frame has no left neighbour
        f = img.shape[0]
        return _take(img, np.where(drop, np.maximum(np.arange(f) - 1, 0), np.arange(f))), mask

    def apply_strength(self, img, mask, strength):
        return self.transform(img, mask, _bernoulli(eval_generator(), strength, img.shape[0]))


# -- video codecs -----------------------------------------------------------------------

def crf_to_quality(crf: float) -> float:
    """Rough CRF -> JPEG-quality mapping of the codec proxy, in float32."""
    return float(np.clip(np.float32(100.0) - np.float32(2.0) * np.float32(crf), 5.0, 95.0))


class _CodecSTE(torch.autograd.Function):
    """The host codec round trip with an identity (straight-through)
    gradient for the frames and none for the crf."""

    @staticmethod
    def forward(ctx, x, crf, codec, fps):
        from .. import native
        out = native.video_roundtrip(x.detach().cpu().numpy(), codec, crf=int(crf), fps=fps)
        return torch.from_numpy(out).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


@dataclasses.dataclass
class VideoCompressionExact(Aug):
    """The exact codec attack through the native libav runtime
    (``native.video_roundtrip``) with a straight-through gradient: one
    device -> host -> device round trip per application."""
    min_crf: int = 28
    max_crf: int = 36
    codec: str = "h264"
    fps: int = 24
    couples_samples = True
    name = "h264"

    def __post_init__(self):
        self.name = self.codec   # row names key the eval's rows

    def sample(self, generator, img):
        return uniform(generator, float(self.min_crf), float(self.max_crf + 1))

    def transform(self, img, mask, params):
        return self.apply_strength(img, mask, params)

    def apply_strength(self, img, mask, strength):
        clean = torch.clamp(img.float(), 0.0, 1.0)
        return _CodecSTE.apply(clean, float(np.float32(strength)), self.codec, self.fps), mask


@dataclasses.dataclass
class VideoCompressionProxy(Aug):
    """On-device differentiable stand-in for h264/h265/vp9/av1: a per-frame
    JPEG proxy at a CRF-derived quality plus a light temporal blend of each
    frame with its neighbours."""
    min_crf: int = 28
    max_crf: int = 36
    codec: str = "h264"
    temporal_mix: float = 0.15
    couples_samples = True
    name = "h264"

    def __post_init__(self):
        self.name = self.codec

    def sample(self, generator, img):
        return _randint(generator, self.min_crf, self.max_crf + 1)

    def transform(self, img, mask, params):
        return self.apply_strength(img, mask, params)

    def apply_strength(self, img, mask, strength):
        out = jpeg_roundtrip(img, crf_to_quality(strength), subsample=self.codec != "h264rgb")
        if img.dim() == 4 and img.shape[0] > 1 and self.temporal_mix > 0:
            prev = torch.cat([out[:1], out[:-1]], dim=0)
            nxt = torch.cat([out[1:], out[-1:]], dim=0)
            m = self.temporal_mix
            out = (1 - 2 * m) * out + m * prev + m * nxt
        return out, mask
