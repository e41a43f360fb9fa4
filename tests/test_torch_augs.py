"""The port's attack simulator (videoseal_tpu_torch.augmentation, ops/warp,
ops/jpeg) against the JAX package's, on frames made from a numpy seed:
every aug at every strength of the image and video grids and the extended
rows, the transforms behind `apply` at the same sampled parameters, the
gradients, the augmenter and its presets."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoseal_tpu.augmentation import augs as JA
from videoseal_tpu.augmentation import validation as JV
from videoseal_tpu.ops import jpeg as JJ
from videoseal_tpu.ops import warp as JW
from videoseal_tpu_torch import native
from videoseal_tpu_torch.augmentation import augs as PA
from videoseal_tpu_torch.augmentation import augmenter as PAG
from videoseal_tpu_torch.augmentation import presets
from videoseal_tpu_torch.augmentation import validation as PV
from videoseal_tpu_torch.evals.full import synthetic_samples
from videoseal_tpu_torch.ops import jpeg as PJ

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one shape for images and video: JAX's eager dispatch compiles each op once a shape
IMG_SHAPE = VID_SHAPE = (4, 64, 96, 3)
# the same float32 operations in the same order, but for sum orders (the
# resize matmuls, the blur's taps, the contrast mean, the DCT's 8-term sums)
ATOL = 1e-5
# the perspective's 8x8 homography is solved by another LAPACK routine, which
# moves the sampling coordinates by a few float32 ulps (measured 3.8e-5)
PERSPECTIVE_ATOL = 1e-4
# the JPEG proxy: a coefficient whose quotient lands within an ulp of .5 can
# round the other way; such a pixel moves by at most one quantisation step
JPEG_FLIP_SHARE = 1e-3


def _frames(shape, seed=3):
    x = next(synthetic_samples(1, shape, seed=seed))
    return x, np.ones(shape[:-1] + (1,), np.float32)


def _jpeg_bound(aug, strength) -> float:
    """One quantisation step of the largest table entry, in [0, 1] pixels,
    at the aug's quality (the bound on a flipped rounding's effect)."""
    first = aug.augs[0] if isinstance(aug, PV.Sequential) else aug
    s = strength[0] if isinstance(strength, tuple) else strength
    q = s if isinstance(first, PA.JPEG) else PA.crf_to_quality(s)
    return float(max(PJ.scaled_table(PJ._Q_LUMA, q).max(),
                     PJ.scaled_table(PJ._Q_CHROMA, q).max())) / 255.0


def _holds(aug, strength, got, want):
    """Assert the port's output `got` against JAX's `want` at the aug's
    tolerance."""
    assert got.shape == want.shape
    d = np.abs(got - want)
    names = repr(aug)
    if "Perspective" in names:
        assert d.max() <= PERSPECTIVE_ATOL, (names, strength, d.max())
    elif "JPEG" in names or "VideoCompressionProxy" in names:
        assert (d > ATOL).mean() < JPEG_FLIP_SHARE, (names, strength, (d > ATOL).mean())
        assert d.max() <= _jpeg_bound(aug, strength), (names, strength, d.max())
    else:
        # the exact codec: the same native library on the same bytes
        tol = 0.0 if "VideoCompressionExact" in names else ATOL
        assert d.max() <= tol, (names, strength, d.max())


def _jax_draw_injected(aug, x, m, strength):
    """The JAX output of apply_strength, and the port's at JAX's own eval
    draw where the aug draws from PRNGKey(0) with the frames' shape."""
    jo, jm_ = aug_pair_jax(aug).apply_strength(jnp.asarray(x), jnp.asarray(m), strength)
    key = jax.random.PRNGKey(0)
    tx, tm = torch.as_tensor(x), torch.as_tensor(m)
    if isinstance(aug, PA.GaussianNoise):
        noise = torch.as_tensor(np.array(jax.random.normal(key, x.shape, jnp.float32)))
        po, pm_ = aug.transform(tx, tm, (strength, noise))
    elif isinstance(aug, PA.TemporalReorder):
        p = strength[1] if isinstance(strength, tuple) else strength
        po, pm_ = aug.transform(tx, tm, np.asarray(jax.random.bernoulli(key, p, (x.shape[0] // 2,))))
    elif isinstance(aug, PA.DropFrame):
        po, pm_ = aug.transform(tx, tm, np.asarray(jax.random.bernoulli(key, strength, (x.shape[0],))))
    else:
        po, pm_ = aug.apply_strength(tx, tm, strength)
    return np.asarray(jo), np.asarray(jm_), po.numpy(), pm_.numpy()


def aug_pair_jax(aug):
    """The JAX package's aug of the same class and fields as port aug `aug`."""
    if isinstance(aug, PV.Sequential):
        return JV.Sequential(*(aug_pair_jax(a) for a in aug.augs))
    import dataclasses
    return getattr(JA, type(aug).__name__)(**dataclasses.asdict(aug))


def _grid_rows(is_video):
    return list(zip(JV.get_validation_augs(is_video, extended=True),
                    PV.get_validation_augs(is_video, extended=True)))


# the extended grids' row counts: 15 + 3 combined image rows, 18 + 4 video
@pytest.mark.parametrize("is_video,row", [(False, i) for i in range(18)]
                         + [(True, i) for i in range(22)])
def test_grid_row_matches_jax(is_video, row):
    """Each row of the extended image and video grids: the same aug (repr)
    and strengths as the JAX package's, and at each strength the port's
    apply_strength against JAX's (JAX's PRNGKey(0) draw injected where the
    draw depends on the shape)."""
    rows = _grid_rows(is_video)
    assert len(rows) == (22 if is_video else 18)
    (ja, js), (pa, ps) = rows[row]
    assert repr(pa) == repr(ja) and ps == js
    x, m = _frames(VID_SHAPE if is_video else IMG_SHAPE)
    for s in ps:
        jo, jmask, po, pmask = _jax_draw_injected(pa, x, m, s)
        _holds(pa, s, po, jo)
        np.testing.assert_allclose(pmask, jmask, atol=PERSPECTIVE_ATOL)


@pytest.mark.parametrize("codec", ["h264", "h264rgb", "h265", "vp9", "av1"])
def test_codec_proxy_matches_jax(codec):
    """The proxy at every CRF of the video grid (the rows the card's machine
    runs, where the native runtime does not load)."""
    x, m = _frames(VID_SHAPE)
    for crf in (23, 30, 40, 50, -1):
        pa = PA.VideoCompressionProxy(codec=codec)
        jo, _ = JA.VideoCompressionProxy(codec=codec).apply_strength(jnp.asarray(x),
                                                                     jnp.asarray(m), crf)
        po, _ = pa.apply_strength(torch.as_tensor(x), torch.as_tensor(m), crf)
        _holds(pa, crf, po.numpy(), np.asarray(jo))


@pytest.mark.parametrize("is_video", [False, True])
def test_grid_builders_match_jax(is_video):
    """Every grid builder's rows: the same augs (repr) and strengths."""
    def rows(grid):
        return [(repr(a), s) for a, s in grid]
    for name, kw in (("get_validation_augs", {}), ("get_validation_augs", {"only_identity": True}),
                     ("get_validation_augs", {"only_combined": True}),
                     ("get_validation_augs_subset", {}), ("get_validation_augs_geometric", {}),
                     ("get_combined_augs", {})):
        assert rows(getattr(PV, name)(is_video, **kw)) == rows(getattr(JV, name)(is_video, **kw))


def test_bilinear_sample_and_homography_match_jax():
    """The sampler at random coordinates, some outside the image (zero
    fill), and the 8x8 homography solve."""
    from videoseal_tpu_torch.ops import warp as PW
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    xs = rng.uniform(-3, 59, (30, 50)).astype(np.float32)
    ys = rng.uniform(-3, 43, (30, 50)).astype(np.float32)
    got = PW.bilinear_sample(torch.as_tensor(x), torch.as_tensor(xs), torch.as_tensor(ys))
    want = JW.bilinear_sample(jnp.asarray(x), jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    src = np.array([[0, 0], [55, 0], [55, 39], [0, 39]], np.float32)
    dst = src + rng.uniform(-8, 8, src.shape).astype(np.float32)
    np.testing.assert_allclose(PW.solve_homography(src, dst),
                               np.asarray(JW.solve_homography(jnp.asarray(src), jnp.asarray(dst))),
                               rtol=1e-5, atol=1e-6)


def test_perspective_eval_draws_are_jax_prngkey0():
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    want = [float(jax.random.uniform(k, ())) for k in ks]
    assert list(PA.PERSPECTIVE_EVAL_DRAWS) == want


@pytest.mark.parametrize("quality", [1, 10, 25, 49, 50, 51, 60, 75, 90, 100, 33.0, 95.0])
def test_jpeg_tables_match_jax(quality):
    for base in (PJ._Q_LUMA, PJ._Q_CHROMA):
        np.testing.assert_array_equal(PJ.scaled_table(base, quality),
                                      np.asarray(JJ._scaled_table(base, quality)))


@pytest.mark.parametrize("subsample,shape", [(False, (1, 1080, 1920, 3)),
                                             (True, (1, 1080, 1920, 3)),
                                             (False, (1, 60, 64, 3)),
                                             (True, (1, 72, 64, 3))])
def test_jpeg_refuses_unblockable_frames(subsample, shape):
    """With subsample, 1080 rows give 540 chroma rows (not a multiple of 8):
    ValueError, where the JAX package's proxy fails inside its reshape."""
    x = torch.zeros(shape)
    if not subsample and shape[1] == 1080:
        assert PJ.jpeg_roundtrip(x, 50).shape == shape   # 1080 = 135 * 8
        return
    with pytest.raises(ValueError, match="cannot be blocked 8x8"):
        PJ.jpeg_roundtrip(x, 50, subsample=subsample)
    with pytest.raises(TypeError):
        JJ.jpeg_roundtrip(jnp.zeros(shape), 50, subsample=subsample)


# -- the transforms behind apply, at the same sampled parameters ---------------------

def _apply_cases():
    return [
        PA.Rotate(), PA.Rotate(min_angle=-45, max_angle=45, do90=True), PA.Resize(),
        PA.Crop(), PA.Perspective(), PA.HorizontalFlip(), PA.Brightness(), PA.Contrast(),
        PA.Saturation(), PA.Hue(), PA.GaussianBlur(), PA.MedianFilter(max_kernel_size=7),
        PA.GaussianNoise(), PA.Grayscale(), PA.JPEG(), PA.VideoCompressionProxy(),
        PA.VideoCompressionProxy(codec="h264rgb"), PA.SpeedChange(), PA.TemporalReorder(),
        PA.WindowAveraging(), PA.DropFrame(), PA.Identity(),
    ]


def _jax_transform(aug, x, m, params):
    """The JAX package's warps and ops at the port's sampled params."""
    ja = aug_pair_jax(aug)
    x, m = jnp.asarray(x), jnp.asarray(m)
    if isinstance(aug, PA.Rotate):
        angle, k90 = params
        x, m = JW.rotate(x, jnp.float32(angle)), JW.rotate(m, jnp.float32(angle))
        k = (3, 0, 0, 1)[k90] if aug.do90 else 0
        return jnp.rot90(x, k, (-3, -2)), jnp.rot90(m, k, (-3, -2))
    if isinstance(aug, PA.Resize):
        s = np.linspace(aug.min_size, aug.max_size, aug.n_scales)[params]
        oh, ow = max(8, int(round(x.shape[-3] * s))), max(8, int(round(x.shape[-2] * s)))
        return JW.resize_area_scale(x, oh, ow), JW.resize_area_scale(m, oh, ow)
    if isinstance(aug, PA.Crop):
        args = [jnp.int32(v) for v in params]
        return JW.crop_resize(x, *args), JW.crop_resize(m, *args)
    if isinstance(aug, PA.Perspective):
        start, end = PA.perspective_points(x.shape[-3], x.shape[-2], *params)
        return JW.warp_perspective(x, start, end), JW.warp_perspective(m, start, end)
    if isinstance(aug, PA.GaussianBlur):
        return ja._blur(x, params), m
    if isinstance(aug, PA.MedianFilter):
        return ja._median(x, params), m
    if isinstance(aug, PA.GaussianNoise):
        std, noise = params
        return x + jnp.float32(std) * jnp.asarray(noise.numpy()), m
    if isinstance(aug, PA.JPEG):
        return JJ.jpeg_roundtrip(x, jnp.asarray(params)), m
    if isinstance(aug, PA.TemporalReorder):
        swap = np.asarray(params)
        f, half = x.shape[0], x.shape[0] // 2
        perm = np.arange(f)
        perm[:2 * half:2] = np.where(swap, np.arange(1, 2 * half, 2), np.arange(0, 2 * half, 2))
        perm[1:2 * half:2] = np.where(swap, np.arange(0, 2 * half, 2), np.arange(1, 2 * half, 2))
        return x[perm], m[perm]
    if isinstance(aug, PA.DropFrame):
        drop = np.asarray(params).copy()
        drop[0] = False
        idx = np.where(drop, np.maximum(np.arange(x.shape[0]) - 1, 0), np.arange(x.shape[0]))
        return x[idx], m
    if isinstance(aug, (PA.Identity, PA.HorizontalFlip, PA.Grayscale)):
        return ja.apply(None, x, m)
    if isinstance(aug, PA.WindowAveraging):
        return ja.apply(None, x, m)
    return ja.apply_strength(x, m, params)   # the factor, speed and crf augs


@pytest.mark.parametrize("case", range(22))
def test_apply_transform_matches_jax(case):
    """`apply` = sample + transform; the transform at the sampled params
    against the JAX package's warps and ops at the same params, for four
    draws; every draw within the aug's range."""
    aug = _apply_cases()[case]
    square = isinstance(aug, PA.Rotate) and aug.do90
    x, m = _frames((4, 64, 64, 3) if square else VID_SHAPE, seed=case)
    g = torch.Generator().manual_seed(case)
    for _ in range(4):
        params = aug.sample(g, torch.as_tensor(x))
        _check_range(aug, params, x.shape)
        po, pm_ = aug.transform(torch.as_tensor(x), torch.as_tensor(m), params)
        jo, jm_ = _jax_transform(aug, x, m, params)
        _holds(aug, params, po.numpy(), np.asarray(jo))
        np.testing.assert_allclose(pm_.numpy(), np.asarray(jm_), atol=PERSPECTIVE_ATOL)


def _check_range(aug, params, shape):
    f, h, w = shape[0], shape[-3], shape[-2]
    if isinstance(aug, PA.Rotate):
        assert aug.min_angle <= params[0] < aug.max_angle and params[1] in range(4)
    elif isinstance(aug, PA.Resize):
        assert params in range(aug.n_scales)
    elif isinstance(aug, PA.Crop):
        top, left, ch, cw = params
        assert int(aug.min_size * h) <= ch <= int(aug.max_size * h)
        assert int(aug.min_size * w) <= cw <= int(aug.max_size * w)
        assert 0 <= top <= h - ch and 0 <= left <= w - cw
    elif isinstance(aug, PA.Perspective):
        d, u = params
        assert aug.min_distortion_scale <= d < aug.max_distortion_scale
        assert len(u) == 8 and all(0 <= v < 1 for v in u)
    elif isinstance(aug, PA._Factor):
        assert aug.min_factor <= params < aug.max_factor
    elif isinstance(aug, (PA.GaussianBlur, PA.MedianFilter)):
        assert params % 2 == 1 and aug.min_kernel_size <= params <= aug.max_kernel_size | 1
    elif isinstance(aug, PA.GaussianNoise):
        assert aug.min_std <= params[0] < aug.max_std and tuple(params[1].shape) == shape
    elif isinstance(aug, (PA.JPEG,)):
        assert aug.min_quality <= params <= aug.max_quality
    elif isinstance(aug, PA.VideoCompressionProxy):
        assert aug.min_crf <= params <= aug.max_crf
    elif isinstance(aug, PA.SpeedChange):
        assert aug.min_speed <= params < aug.max_speed
    elif isinstance(aug, PA.TemporalReorder):
        assert tuple(params.shape) == (f // 2,)
    elif isinstance(aug, PA.DropFrame):
        assert tuple(params.shape) == (f,)


# -- gradients -------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(23))
def test_gradient_finite(case):
    """A finite gradient through `apply` of every aug (and the exact codec)."""
    aug = (_apply_cases() + [PA.VideoCompressionExact()])[case]
    if isinstance(aug, PA.VideoCompressionExact) and not native.available():
        pytest.skip("the native media runtime does not load here")
    x, m = _frames((4, 64, 64, 3), seed=case)
    img = torch.as_tensor(x).requires_grad_()
    out, _ = aug.apply(torch.Generator().manual_seed(case), img, torch.as_tensor(m))
    out.square().sum().backward()
    assert img.grad is not None and bool(torch.isfinite(img.grad).all())


def test_exact_codec_gradient_finite_and_forward_matches_jax():
    if not (native.available() and native.codec_available("h264")):
        pytest.skip("the native media runtime does not load here")
    x, m = _frames(VID_SHAPE)
    img = torch.as_tensor(x).requires_grad_()
    out, _ = PA.VideoCompressionExact().apply_strength(img, torch.as_tensor(m), 30)
    want, _ = JA.VideoCompressionExact().apply_strength(jnp.asarray(x), jnp.asarray(m), 30)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    v = torch.as_tensor(np.random.default_rng(0).normal(size=x.shape).astype(np.float32))
    (out * v).sum().backward()
    # straight through: the identity where the input lies inside [0, 1]
    inside = (img > 0) & (img < 1)
    assert bool(inside.any())
    torch.testing.assert_close(img.grad[inside], v[inside], rtol=0, atol=0)


# the proxy's colour matrices (JFIF, six digits) are inverse to about 1e-4:
# RGB -> YCbCr -> RGB is this matrix, not exactly the identity
_YCC = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                 [0.5, -0.418688, -0.081312]])
_RGB = np.array([[1, 0, 1.402], [1, -0.344136, -0.714136], [1, 1.772, 0]])


@pytest.mark.parametrize("aug", ["jpeg", "h264rgb"])
def test_jpeg_ste_is_identity(aug):
    """The quantisation's gradient is the identity (straight through) and
    the DCT orthonormal, so the proxy's Jacobian is its colour round trip's
    matrix wherever nothing is clipped."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.3, 0.7, VID_SHAPE).astype(np.float32)
    img = torch.as_tensor(x).requires_grad_()
    a = PA.JPEG() if aug == "jpeg" else PA.VideoCompressionProxy(codec="h264rgb", temporal_mix=0)
    out, _ = a.apply_strength(img, torch.ones(VID_SHAPE[:-1] + (1,)), 90)
    v = torch.as_tensor(rng.normal(size=x.shape).astype(np.float32))
    (out * v).sum().backward()
    inside = ((out > 0) & (out < 1)).all(dim=-1)
    assert float(inside.float().mean()) > 0.99
    want = torch.as_tensor((v.double().numpy() @ (_RGB @ _YCC)).astype(np.float32))
    torch.testing.assert_close(img.grad[inside], want[inside], rtol=0, atol=1e-5)


# -- the augmenter ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(presets.AUGS))
def test_presets_equal_yaml(name):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(ROOT, "videoseal_tpu", "configs", f"{name}.yaml")) as f:
        assert presets.AUGS[name] == yaml.safe_load(f)


def test_augmenter_selection_frequencies():
    """4,000 draws of the geometric pool on images: each aug's frequency
    within 5 binomial sigmas of its normalised probability; the video-only
    augs (h264, h265) are not in the image pool."""
    aug = PAG.build_augmenter(presets.AUGS["augs_geometric"])
    assert "h264" not in aug.aug_names() and "h264" in aug.aug_names(is_video=True)
    assert len(aug.aug_names()) == 12 and len(aug.aug_names(is_video=True)) == 14
    assert aug.aug_names() == [n for n in presets.AUGS["augs_geometric"]["augs"]
                               if n not in ("h264", "h265")]
    aug.augs = [PA.Identity()] * len(aug.augs)   # the draw alone is under test
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand((1, 16, 16, 3), generator=g)
    counts = np.zeros(len(aug.augs))
    n = 4000
    for _ in range(n):
        counts[aug(g, imgs, imgs, train=False)[2][0]] += 1
    p = aug.probs.astype(np.float64)
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 5 * sigma), (counts, n * p)


def test_augmenter_mask_blend_and_dummy():
    g = torch.Generator().manual_seed(1)
    imgs = torch.rand((2, 32, 32, 3), generator=g)
    imgs_w = (imgs + 0.01).clamp(0, 1)
    out, mask, sel = PAG.get_dummy_augmenter()(g, imgs_w, imgs)
    assert sel == [0] and torch.equal(out, imgs_w) and torch.equal(mask, torch.ones(2, 32, 32, 1))
    cfg = dict(presets.AUGS["augs_identity"], masks={"kind": "rect", "invert_proba": 0.0})
    out, mask, _ = PAG.build_augmenter(cfg)(g, imgs_w, imgs)
    assert tuple(mask.shape) == (2, 32, 32, 1) and 0 < float(mask.mean()) < 1
    torch.testing.assert_close(out, imgs_w * mask + imgs * (1 - mask))
    with pytest.raises(ValueError, match="not found"):
        PAG.Augmenter({"nope": 1}, {})
