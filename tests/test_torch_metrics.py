"""The port's metrics (videoseal_tpu_torch.ops.metrics) against the JAX
package's (videoseal_tpu.ops.metrics), every function, on inputs made from a
numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoseal_tpu.ops import metrics as jm
from videoseal_tpu_torch.ops import metrics as pm

torch.set_num_threads(1)

# SSIM and MS-SSIM: the same f32 arithmetic, the depthwise convs' sums in
# another order (XLA against torch's CPU conv), on [0, 1] images
SSIM_ATOL = 1e-5
# PSNR, L_inf, capacity: the same f32 arithmetic elementwise
ATOL = 1e-5


def _imgs(seed, shape=(3, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return x, y


def _both(fn_name, *args, **kw):
    j = np.asarray(getattr(jm, fn_name)(*(jnp.asarray(a) for a in args), **kw))
    p = getattr(pm, fn_name)(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)
    return j, p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


@pytest.mark.parametrize("is_video", [False, True])
def test_psnr(is_video):
    x, y = _imgs(0)
    j, p = _both("psnr", x, y, is_video=is_video)
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, atol=ATOL, rtol=1e-6)


def test_linf():
    x, y = _imgs(1)
    j, p = _both("linf", x, y)
    np.testing.assert_allclose(p, j, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 40, 48, 3), (1, 33, 29, 1)])
def test_ssim(shape):
    x, y = _imgs(2, shape)
    j, p = _both("ssim", x, y)
    assert p.shape == j.shape == (shape[0],)
    np.testing.assert_allclose(p, j, atol=SSIM_ATOL)


def test_ssim_exceeds_one_unclamped():
    """Near-constant frames at |x| ~ 30: the covariance form's cancellation
    (E[x^2] - mu^2 in f32) pushes SSIM over 1 in both packages; neither
    clamps. The two round the cancellation differently (the convs' sums in
    another order), so they agree to the cancellation's size, ~30^2 * 2^-24
    per sum against c2 = 9e-4 (measured 7.7e-3), not to SSIM_ATOL."""
    rng = np.random.default_rng(0)
    x = (30.0 + rng.normal(0, 1e-3, (4, 32, 32, 3))).astype(np.float32)
    y = (x + rng.normal(0, 1e-3, x.shape)).astype(np.float32)
    j, p = _both("ssim", x, y)
    assert j.max() > 1.0 and p.max() > 1.0
    np.testing.assert_allclose(p, j, atol=2e-2)


@pytest.mark.parametrize("shape", [(2, 176, 176, 3), (1, 181, 167, 1)])
def test_ms_ssim(shape):
    """Five levels; the odd sizes take the symmetric zero pad of torch's
    avg_pool2d at every level."""
    x, y = _imgs(3, shape)
    j, p = _both("ms_ssim", x, y)
    assert p.shape == j.shape == (shape[0],)
    np.testing.assert_allclose(p, j, atol=SSIM_ATOL)


def test_avg_pool2_torch():
    x = np.random.default_rng(4).uniform(0, 1, (2, 7, 9, 3)).astype(np.float32)
    j = np.asarray(jm._avg_pool2_torch(jnp.asarray(x)))
    p = pm._avg_pool2_torch(torch.from_numpy(x)).numpy()
    assert p.shape == j.shape == (2, 4, 5, 3)
    np.testing.assert_allclose(p, j, atol=1e-7)


def test_gaussian_filter():
    x = np.random.default_rng(5).uniform(0, 1, (2, 20, 24, 3)).astype(np.float32)
    win = jm._fspecial_gauss_1d(11, 1.5)
    np.testing.assert_array_equal(pm._fspecial_gauss_1d(11, 1.5), win)
    j = np.asarray(jm._gaussian_filter(jnp.asarray(x), jnp.asarray(win)))
    p = pm._gaussian_filter(torch.from_numpy(x), torch.from_numpy(win)).numpy()
    np.testing.assert_allclose(p, j, atol=1e-6)


@pytest.mark.parametrize("label", [0, 1])
def test_iou(label):
    rng = np.random.default_rng(6)
    preds = rng.normal(0, 1, (4, 16, 16, 1)).astype(np.float32)
    targets = (rng.uniform(0, 1, preds.shape) > 0.5).astype(np.float32)
    targets[3] = 0.0
    preds[3] = -1.0          # an empty union: IoU 1
    j, p = _both("iou", preds, targets, label=label)
    np.testing.assert_allclose(p, j, atol=1e-7)


def test_accuracy():
    rng = np.random.default_rng(7)
    preds = rng.normal(0, 1, (3, 16, 16, 1)).astype(np.float32)
    targets = (rng.uniform(0, 1, preds.shape) > 0.5).astype(np.float32)
    j, p = _both("accuracy", preds, targets)
    np.testing.assert_allclose(p, j, atol=1e-7)


def _bits(seed, b=3, h=8, w=8, k=16):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 2, (b, k)).astype(np.float32)
    flat = rng.normal(0, 1, (b, k)).astype(np.float32)
    pix = rng.normal(0, 1, (b, h, w, k)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, h, w, 1)) > 0.4).astype(np.float32)
    return targets, flat, pix, mask


def test_bit_accuracy_flat_and_pixelwise():
    targets, flat, pix, mask = _bits(8)
    for args in ((flat, targets), (pix, targets)):
        j, p = _both("bit_accuracy", *args)
        np.testing.assert_allclose(p, j, atol=1e-7)


def test_bit_accuracy_masked_with_empty_mask():
    """An item whose mask is empty gives NaN in both, as the reference's
    masked_select path does."""
    targets, _, pix, mask = _bits(9)
    mask[1] = 0.0
    mask[2] *= 0.3           # fractional edge values: any nonzero pixel counts
    j = np.asarray(jm.bit_accuracy(jnp.asarray(pix), jnp.asarray(targets),
                                   mask=jnp.asarray(mask)))
    p = pm.bit_accuracy(torch.from_numpy(pix), torch.from_numpy(targets),
                        mask=torch.from_numpy(mask)).numpy()
    assert np.isnan(j[1]) and np.isnan(p[1])
    np.testing.assert_allclose(p, j, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_bit_accuracy_1msg(masked):
    targets, _, pix, mask = _bits(10)
    kw = {"masks": mask} if masked else {}
    j = np.asarray(jm.bit_accuracy_1msg(jnp.asarray(pix), jnp.asarray(targets),
                                        **{k: jnp.asarray(v) for k, v in kw.items()}))
    p = pm.bit_accuracy_1msg(torch.from_numpy(pix), torch.from_numpy(targets),
                             **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(p, j, atol=1e-6)


@pytest.mark.parametrize("method", ["hard", "semihard", "soft"])
def test_bit_accuracy_inference(method):
    targets, _, pix, mask = _bits(11)
    j, p = _both("bit_accuracy_inference", pix, targets, mask, method=method)
    np.testing.assert_allclose(p, j, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_bit_accuracy_mv(masked):
    targets, _, pix, mask = _bits(12)
    args = (pix, targets, mask) if masked else (pix, targets)
    j, p = _both("bit_accuracy_mv", *args)
    np.testing.assert_allclose(p, j, atol=1e-7)


@pytest.mark.parametrize("piecewise", [0, 1])
def test_bd_rate(piecewise):
    r1 = np.array([100.0, 200.0, 400.0, 800.0])
    r2 = np.array([90.0, 185.0, 370.0, 760.0])
    p1 = np.array([30.0, 33.1, 36.0, 38.7])
    p2 = np.array([30.2, 33.3, 36.1, 38.9])
    j = jm.bd_rate(r1, p1, r2, p2, piecewise=piecewise)
    p = pm.bd_rate(r1, p1, r2, p2, piecewise=piecewise)
    assert isinstance(p, float) and p == j


def test_pvalue():
    accs = np.array([0.5, 0.75, 0.96875, 1.0], np.float32)
    j = jm.pvalue(accs, 32)
    p = pm.pvalue(torch.from_numpy(accs), 32)
    np.testing.assert_array_equal(p, j)


def test_capacity():
    accs = np.array([0.0, 0.5, 0.75, 0.99, 1.0], np.float32)
    j, p = _both("capacity", accs, nbits=256)
    np.testing.assert_allclose(p, j, atol=1e-4, rtol=1e-6)
