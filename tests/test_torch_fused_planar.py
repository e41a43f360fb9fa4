"""K1's plain version against the Pallas kernel fused_jnd_blend_planar run
in interpret mode, for both branches with and without the detect output.
The CUDA kernel is held against the same plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoseal_tpu.kernels import fused_planar as jfp
from videoseal_tpu_torch.kernels import fused_planar as tfp

torch.set_num_threads(1)

F, H, W, S = 2, 160, 256, 128


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (F, H, W, 3), np.uint8)
    pred = rng.uniform(-1, 1, (F, S, S)).astype(np.float32)
    return np.array(jfp.pack_planar(imgs)), pred


@pytest.mark.parametrize("detect", [None, 128])
@pytest.mark.parametrize("lowres", [True, False])
def test_plain_matches_pallas(inputs, lowres, detect):
    imgs_p, pred = inputs
    want = jfp.fused_jnd_blend_planar(jnp.asarray(imgs_p), jnp.asarray(pred), 0.2, 1.0,
                                      H, W, interpret=True, detect_size=detect,
                                      lowres=lowres)
    got = tfp.fused_jnd_blend_planar(torch.from_numpy(imgs_p), torch.from_numpy(pred),
                                     0.2, 1.0, H, W, detect_size=detect, lowres=lowres)
    if detect:
        (want, want_det), (got, got_det) = want, got
    want = np.asarray(want).astype(np.int16)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    # u8: f32 sums in another order can flip a value that lands on .5 when
    # rounded, so within 1 LSB on fewer than 1e-3 of the pixels
    d = np.abs(got.numpy().astype(np.int16) - want)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-3, (d > 0).mean()
    # rows/cols beyond the image are what the JAX output holds there
    assert np.array_equal(got.numpy()[:, :, H:], want[:, :, H:].astype(np.uint8))
    if detect:
        want_det = np.asarray(want_det)
        assert tuple(got_det.shape) == want_det.shape == (F, 3, detect, detect)
        # bf16 rounding of vd on both sides; an isolated 1-LSB u8 flip moves
        # a detect pixel by < 1e-3, other f32 sum-order differences far less
        np.testing.assert_allclose(got_det.numpy(), want_det, atol=2e-3)


def test_rejects_wrong_buffer(inputs):
    imgs_p, pred = inputs
    with pytest.raises(ValueError, match="planar_shape"):
        tfp.fused_jnd_blend_planar(torch.from_numpy(imgs_p[:, :, 1:]),
                                   torch.from_numpy(pred), 0.2, 1.0, H, W)


@pytest.mark.parametrize("h,w", [(1080, 1920), (720, 1280)])
def test_band_tables_reproduce_dense_matrices(h, w):
    """The kernels' banded (start, weights) tables equal the dense resize
    matrices they stand for, at the main path's 1080p shapes and at 720p:
    K1's lift and width bands zero-padded to (hout, wq), K4's (no padding),
    and the detect downscale's."""
    from videoseal_tpu_torch.ops.resize import _resize_matrix
    n_tiles, _, _, wq = tfp.planar_geometry(h, w)
    hout = tfp.TH * n_tiles
    for pad_h, pad_w, ds in ((hout, wq, 256), (h, w, 0)):
        tabs = tfp._tables_np(256, h, w, pad_h, pad_w, ds)
        dense = {"lift": np.zeros((pad_h, 256), np.float32),
                 "width": np.zeros((pad_w, 256), np.float32)}
        dense["lift"][:h] = _resize_matrix(256, h)
        dense["width"][:w] = _resize_matrix(256, w)
        if ds:
            dense["dw"] = _resize_matrix(w, ds)
            dense["dh"] = _resize_matrix(h, ds) / 255.0
        assert set(tabs) == set(dense)
        assert tabs["width"][2] == tfp.WIDTH_TAPS   # the kernels' register taps
        for name, m in dense.items():
            start, wt, taps = tabs[name]
            back = np.zeros_like(m)
            for i in range(m.shape[0]):
                back[i, start[i]:start[i] + taps] = wt[i]
            assert np.array_equal(back, m), name


@pytest.mark.parametrize("s,h", [(256, 1080), (256, 720), (64, 160), (256, 100)])
def test_window_rows_cover_each_strip(s, h):
    """_window_rows is the most low-res rows any strip of RS output rows
    lifts from: every valid output row's taps lie in its strip's window."""
    hout = -(-h // 96) * 96
    start, wt, taps = tfp._tables_np(s, h, h, hout, h, 0)["lift"]
    nl = tfp._window_rows(s, h, hout)
    for y0 in range(0, h, tfp.RS):
        rows = range(y0, min(y0 + tfp.RS, h))
        lo = start[y0]
        assert all(start[y] >= lo and start[y] + taps <= lo + nl for y in rows)
    assert nl <= s
