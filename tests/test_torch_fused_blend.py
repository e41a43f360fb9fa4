"""K4, K5 and K6's plain versions against the Pallas kernels of
videoseal_tpu/kernels/fused_blend.py run in interpret mode, and K4's plain
version against the JAX package's XLA path at a height the Pallas kernel
cannot tile. The CUDA kernels are held against the same plain versions on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoseal_tpu.kernels import fused_blend as jfb
from videoseal_tpu.modules.jnd import JND as JaxJND
from videoseal_tpu.ops.resize import resize_bilinear as jax_resize
from videoseal_tpu_torch.kernels import fused_blend as tfb
from videoseal_tpu_torch.modules.jnd import JND

torch.set_num_threads(1)

# JAX-tileable (th = 120), with a width that is not a multiple of 128
F, H, W, S = 2, 120, 200, 64
SW, SI = 0.2, 1.0
# the delta is sw * heat * pred with heat in [0, ~0.1]: |delta| < 0.02. The
# plain versions repeat the kernels' formulation with f32 sums in another
# order (and the lift as a dense matmul), ~1e-5 relative on the delta
DELTA_ATOL = 2e-7
# against the XLA path: JND.heatmaps computes cm^2.4 as sqrt(cm2)**2.4 and
# the luminance as 255 * x first, a few f32 ulps of the heat apart: the same
# ~1e-5 relative on the delta
XLA_ATOL = 2e-7
# K6 outputs are in [0, 1]: si * img + delta rounds to f32 at 6e-8
BLEND_ATOL = 2e-7


def _frames(rng, dtype, f=F, h=H, w=W):
    if dtype == "uint8":
        return rng.integers(0, 256, (f, h, w, 3), np.uint8)
    return rng.uniform(0, 1, (f, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_delta_up_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    imgs = _frames(rng, dtype)
    pred_low = rng.uniform(-1, 1, (F, S, S)).astype(np.float32)
    want = np.asarray(jfb.fused_jnd_delta_up(jnp.asarray(imgs), jnp.asarray(pred_low), SW,
                                             interpret=True))
    got = tfb.fused_jnd_delta_up(torch.from_numpy(imgs), torch.from_numpy(pred_low), SW)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (F, H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=DELTA_ATOL)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_delta_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    imgs = _frames(rng, dtype)
    pred = rng.uniform(-1, 1, (F, H, W)).astype(np.float32)
    want = np.asarray(jfb.fused_jnd_delta(jnp.asarray(imgs), jnp.asarray(pred), SW,
                                          interpret=True))
    got = tfb.fused_jnd_delta(torch.from_numpy(imgs), torch.from_numpy(pred), SW)
    assert tuple(got.shape) == want.shape == (F, H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=DELTA_ATOL)


@pytest.mark.parametrize("pred_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pred_c", [1, 3])
def test_blend_matches_pallas(pred_c, pred_dtype):
    rng = np.random.default_rng(3)
    imgs = _frames(rng, "float32")
    preds = rng.uniform(-1, 1, (F, H, W, pred_c)).astype(np.float32)
    jp = jnp.asarray(preds).astype(pred_dtype)
    tp = torch.from_numpy(preds).to(getattr(torch, pred_dtype))
    # both sides read the same bf16 values
    assert np.array_equal(np.asarray(jp.astype(jnp.float32)), tp.float().numpy())
    want = np.asarray(jfb.fused_jnd_blend(jnp.asarray(imgs), jp, SI, SW, interpret=True))
    got = tfb.fused_jnd_blend(torch.from_numpy(imgs), tp, SI, SW)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (F, H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=BLEND_ATOL)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_blend_up_matches_jax(dtype):
    """K4's blend mode against the JAX package's result for a 1-channel
    prediction: the Pallas delta (interpret mode), then its one fused XLA
    pass (videoseal_tpu/models/videoseal.py:225-232). f32 frames within
    BLEND_ATOL; u8 frames within 1 LSB on fewer than 1e-3 of the values (the
    delta's ~1e-5 relative error can flip a value that lands on .5)."""
    rng = np.random.default_rng(8)
    imgs = _frames(rng, dtype)
    pred_low = rng.uniform(-1, 1, (F, S, S)).astype(np.float32)
    si = 0.95
    ji = jnp.asarray(imgs)
    delta = jfb.fused_jnd_delta_up(ji, jnp.asarray(pred_low), SW, interpret=True)
    if dtype == "uint8":
        out = si * ji.astype(jnp.float32) + 255.0 * delta[..., None]
        want = np.asarray(jnp.clip(jnp.round(out), 0.0, 255.0).astype(jnp.uint8))
    else:
        want = np.asarray(jnp.clip(si * ji + delta[..., None], 0.0, 1.0))
    before = tfb.fused_jnd_delta_up.launches
    got = tfb.fused_jnd_blend_up(torch.from_numpy(imgs), torch.from_numpy(pred_low), si, SW)
    assert tfb.fused_jnd_delta_up.launches == before   # the CPU runs the plain version
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    if dtype == "uint8":
        d = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=BLEND_ATOL)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_blend_up_is_delta_then_blend(dtype):
    """The blend mode's plain version is the delta's followed by the torch
    lines the NHWC embed ran after it, at an untileable height."""
    rng = np.random.default_rng(10)
    imgs = torch.from_numpy(_frames(rng, dtype, h=122))
    pred_low = torch.from_numpy(rng.uniform(-1, 1, (F, S, S)).astype(np.float32))
    delta = tfb.fused_jnd_delta_up(imgs, pred_low, SW)
    if dtype == "uint8":
        out = imgs.float().mul_(SI)
        out += 255.0 * delta[..., None]
        want = out.round_().clamp_(0.0, 255.0).to(torch.uint8)
    else:
        want = torch.clamp(SI * imgs + delta[..., None], 0.0, 1.0)
    assert torch.equal(tfb.fused_jnd_blend_up(imgs, pred_low, SI, SW), want)


def test_delta_up_against_delta():
    """K4(pred_low) == K5(resize(pred_low)), the JAX package's own check
    (tests/test_fused_blend.py::TestFusedDeltaUp) on the port's plain versions."""
    from videoseal_tpu_torch.ops.resize import resize_bilinear
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(_frames(rng, "uint8"))
    pred_low = torch.from_numpy(rng.uniform(-1, 1, (F, S, S)).astype(np.float32))
    full = resize_bilinear(pred_low[..., None], H, W)[..., 0]
    np.testing.assert_allclose(tfb.fused_jnd_delta_up(imgs, pred_low, SW).numpy(),
                               tfb.fused_jnd_delta(imgs, full, SW).numpy(), atol=DELTA_ATOL)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_delta_up_untileable_height_matches_xla(dtype):
    """H = 122 has no Pallas row tile; the port's kernels take any H. Held
    against the XLA path: JND.heatmaps times the upsampled prediction."""
    h = 122
    assert jfb._pick_tile_delta(h, W) is None
    rng = np.random.default_rng(5)
    imgs = _frames(rng, dtype, h=h)
    pred_low = rng.uniform(-1, 1, (F, S, S)).astype(np.float32)
    x = imgs.astype(np.float32) / 255.0 if dtype == "uint8" else imgs
    heat = np.asarray(JaxJND(1, 1).heatmaps(jnp.asarray(x)))[..., 0]
    up = np.asarray(jax_resize(jnp.asarray(pred_low[..., None]), h, W))[..., 0]
    want = SW * heat * up
    got = tfb.fused_jnd_delta_up(torch.from_numpy(imgs), torch.from_numpy(pred_low), SW)
    np.testing.assert_allclose(got.numpy(), want, atol=XLA_ATOL)


ATTENUATIONS = {"jnd_1_1": (1, 1, False), "jnd_1_3": (1, 3, False), "jnd_3_1": (3, 1, False),
                "jnd_3_3": (3, 3, False), "jnd_1_3_blue": (1, 3, True), "none": None}


@pytest.mark.parametrize("pred_c", [1, 2, 3])
@pytest.mark.parametrize("method", ["additive", "multiplicative"])
@pytest.mark.parametrize("att", list(ATTENUATIONS))
def test_supports_fused_blend_agrees(att, method, pred_c):
    """The port's predicate is the JAX one's math conditions; 1080x1920 is a
    size where the JAX tile and VMEM rules pass."""
    spec = ATTENUATIONS[att]
    jatt = None if spec is None else JaxJND(spec[0], spec[1], blue=spec[2])
    tatt = None if spec is None else JND(spec[0], spec[1], blue=spec[2])
    want = jfb.supports_fused_blend(1080, 1920, pred_c, jatt, method)
    assert tfb.supports_fused_blend(pred_c, tatt, method) == want


def test_blue_tint_matches_jax():
    x = np.random.default_rng(6).uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    want = np.asarray(JaxJND(1, 3, blue=True).heatmaps(jnp.asarray(x)))
    got = JND(1, 3, blue=True).heatmaps(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)  # as test_jnd_heatmaps


@pytest.mark.parametrize("fn,args", [
    ("fused_jnd_delta_up", (torch.zeros(1, 8, 8), 0.2)),
    ("fused_jnd_delta", (torch.zeros(1, 8, 8), 0.2)),
    ("fused_jnd_blend", (torch.zeros(1, 8, 8, 1), 1.0, 0.2)),
])
def test_wrappers_count_no_cpu_launch(fn, args):
    """A CPU tensor runs the plain version and counts no kernel launch."""
    wrapper = getattr(tfb, fn)
    before = wrapper.launches
    out = wrapper(torch.zeros(1, 8, 8, 3), *args)
    assert wrapper.launches == before and bool(torch.isfinite(out).all())
