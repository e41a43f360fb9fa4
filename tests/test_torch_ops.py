"""Port ops against the JAX package: resize matrices, resize_bilinear,
resize_planar (both precisions) and rgb_to_y."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoseal_tpu.kernels import fused_planar as jfp
from videoseal_tpu.ops import resize as jresize
from videoseal_tpu.ops.color import rgb_to_y as j_rgb_to_y
from videoseal_tpu_torch.kernels import fused_planar as tfp
from videoseal_tpu_torch.ops import resize as tresize
from videoseal_tpu_torch.ops.color import rgb_to_y

torch.set_num_threads(1)


@pytest.mark.parametrize("n_in,n_out,aa", [
    (1080, 256, True), (1920, 256, True), (256, 1080, True), (256, 1920, True),
    (160, 128, True), (64, 128, False), (7, 7, True), (300, 97, False)])
def test_resize_matrix_bit_equal(n_in, n_out, aa):
    a = tresize._resize_matrix(n_in, n_out, aa)
    b = jresize._resize_matrix(n_in, n_out, aa)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("shape,out,aa", [((2, 40, 56, 3), (24, 32), True),
                                          ((3, 16, 16, 8), (32, 32), False)])
def test_resize_bilinear_highest(shape, out, aa):
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), *out, antialias=aa))
    got = tresize.resize_bilinear(torch.from_numpy(x), *out, antialias=aa).numpy()
    # both are f32 products of the same matrices; only the summation order differs
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_resize_bilinear_default_is_bf16():
    """precision="default" rounds inputs, tables and the height result to
    bf16: within 3 LSB at 8-bit scale of the f32 JAX result."""
    x = np.random.default_rng(1).uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), 24, 32))
    got = tresize.resize_bilinear(torch.from_numpy(x), 24, 32, precision="default")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3 / 255)


def test_rgb_to_y():
    x = np.random.default_rng(2).uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(j_rgb_to_y(jnp.asarray(x)))
    got = rgb_to_y(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert got.shape == (2, 5, 7, 1)


def _planar(F, H, W, seed):
    imgs = np.random.default_rng(seed).integers(0, 256, (F, H, W, 3), np.uint8)
    return np.array(jfp.pack_planar(imgs)), imgs


@pytest.mark.parametrize("hw", [(160, 256), (200, 300)])
def test_pack_unpack_planar(hw):
    H, W = hw
    jp, imgs = _planar(2, H, W, 3)
    tp = tfp.pack_planar(torch.from_numpy(imgs))
    assert tuple(tp.shape) == tfp.planar_shape(2, H, W) == jfp.planar_shape(2, H, W)
    assert np.array_equal(tp.numpy(), jp)
    assert tfp.planar_geometry(H, W) == jfp.planar_geometry(H, W)
    assert np.array_equal(tfp.unpack_planar(tp[:, :, 28:, 128:], H, W).numpy(), imgs)


@pytest.mark.parametrize("r0,c0", [(28, 128), (0, 0)])
def test_resize_planar_highest(r0, c0):
    jp, _ = _planar(2, 160, 256, 4)
    want = np.asarray(jfp.resize_planar(jnp.asarray(jp), 160, 256, 128, 128, r0=r0, c0=c0))
    got = tfp.resize_planar(torch.from_numpy(jp), 160, 256, 128, 128, r0=r0, c0=c0)
    # f32 on both sides, summation order differs
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_resize_planar_default():
    """bf16 serving path on both sides: same roundings, f32 accumulation in
    another order, so within 1 LSB at 8-bit scale."""
    jp, _ = _planar(2, 160, 256, 5)
    want = np.asarray(jfp.resize_planar(jnp.asarray(jp), 160, 256, 128, 128,
                                        precision="default"))
    got = tfp.resize_planar(torch.from_numpy(jp), 160, 256, 128, 128, precision="default")
    np.testing.assert_allclose(got.numpy(), want, atol=1 / 255)
    with pytest.raises(ValueError):
        tfp.resize_planar(torch.from_numpy(jp), 160, 256, 128, 128, precision="high")
