"""The port's NHWC path against the JAX package end to end:
VideoSeal.embed (float and u8 frames, image and video, the three video modes,
a frame count the step does not divide, lowres attenuation on and off, a
3-channel card and a multiplicative card), then detect and extract_message.

The JAX side runs at PipelineConfig defaults, i.e. its XLA path
(JND.heatmaps times the upsampled prediction, then blend). The port takes
its kernel routes, which run their plain versions on the CPU: K4 for a
1-channel prediction, K6 for a 3-channel one on float frames, blend for the
rest."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port import LOGIT_ATOL, NBITS, jax_model, port_model, tiny_card, to_np

from videoseal_tpu.models.videoseal import VideoSeal as JaxVideoSeal
from videoseal_tpu_torch.kernels import fused_blend

torch.set_num_threads(1)

S, H, W = 64, 72, 120   # square processing grid; a width that is not a multiple of 128
# preds_w: the embedders run f32 convolutions in another order (as in
# test_torch_modules.test_embedder_matches_linen)
PREDS_ATOL = 2e-5
# float imgs_w: the prediction's error times sw * heat (< 0.02), plus f32
# rounding of si * img + delta in [0, 1]
FLOAT_ATOL = 1e-6

# card: (tiny model, blending method); "mult" shares the weights of "lum"
CARDS = {"lum": ("lum", "additive"), "rgb": ("rgb", "additive"),
         "mult": ("lum", "multiplicative")}
# name: (card, dtype, is_video, frames, video_mode, lowres_attenuation)
CASES = {
    "image_float": ("lum", "float32", False, 3, "repeat", False),
    "image_u8": ("lum", "uint8", False, 3, "repeat", False),
    "video_u8_repeat": ("lum", "uint8", True, 7, "repeat", False),
    "video_float_alternate": ("lum", "float32", True, 7, "alternate", False),
    "video_u8_interpolate": ("lum", "uint8", True, 7, "interpolate", False),
    "video_u8_lowres": ("lum", "uint8", True, 7, "repeat", True),
    "image_float_lowres": ("lum", "float32", False, 3, "repeat", True),
    "rgb_image_float": ("rgb", "float32", False, 3, "repeat", False),
    "rgb_video_float": ("rgb", "float32", True, 7, "interpolate", False),
    "rgb_video_u8": ("rgb", "uint8", True, 7, "repeat", False),
    "mult_image_float": ("mult", "float32", False, 3, "repeat", False),
    "mult_video_u8": ("mult", "uint8", True, 7, "repeat", False),
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, (name, out_channels) in enumerate((("lum", 1), ("rgb", 3))):
        card = tiny_card(img_size=S, step=2, chunk=4, out_channels=out_channels)
        jm = jax_model(card, seed=21 + i)
        out[name] = (jm, port_model(card, jm))
    return out


def _frames(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, (n, H, W, 3), np.uint8)
    return rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)


def _pair(models, card, video_mode, clamp=True):
    """The JAX and port models of `card` with `video_mode`, the card's
    blending method and `clamp` in their configs."""
    base, blending = CARDS[card]
    jm, pm = models[base]
    cfg = dataclasses.replace(jm.cfg, video_mode=video_mode, blending_method=blending,
                              clamp=clamp)
    jv = JaxVideoSeal(jm.embedder_spec, jm.extractor_spec, jm.embedder_vars, jm.extractor_vars,
                      jm.attenuation, cfg, scaling_w=jm.scaling_w, scaling_i=jm.scaling_i)
    pm.cfg = dataclasses.replace(pm.cfg, video_mode=video_mode, blending_method=blending,
                                 clamp=clamp)
    return jv, pm


def _embed_both(models, case):
    card, dtype, is_video, n, mode, lowres = CASES[case]
    jv, pm = _pair(models, card, mode)
    imgs = _frames(dtype, n, seed=len(case))
    msgs = np.random.default_rng(3).integers(0, 2, (1 if is_video else n, NBITS)).astype(np.int32)
    j = jv.embed(jnp.asarray(imgs), msgs=jnp.asarray(msgs), is_video=is_video,
                 lowres_attenuation=lowres)
    t = pm.embed(torch.from_numpy(imgs), msgs=torch.from_numpy(msgs).long(), is_video=is_video,
                 lowres_attenuation=lowres)
    return imgs, j, t, pm


def _assert_frames_agree(got, want, dtype):
    assert tuple(got.shape) == want.shape
    if dtype == "uint8":
        assert got.dtype == torch.uint8
        # f32 sums in another order may flip a rounding at .5: within 1 LSB
        d = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 1, d.max()
        assert (d > 0).mean() < 1e-3, (d > 0).mean()
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_embed_matches_jax(models, case):
    card, dtype, is_video, n, _, lowres = CASES[case]
    launches = fused_blend.fused_jnd_delta_up.launches
    imgs, j, t, pm = _embed_both(models, case)
    assert fused_blend.fused_jnd_delta_up.launches == launches  # CPU: plain versions only
    _assert_frames_agree(t["imgs_w"], np.asarray(j["imgs_w"]), dtype)
    want = np.asarray(j["preds_w"])
    got = t["preds_w"]
    assert tuple(got.shape) == want.shape == (n, H, W, 3 if card == "rgb" else 1)
    if not lowres and card != "mult" and (card, dtype) != ("rgb", "uint8"):
        # on its kernel routes the port returns the prediction before the
        # full-resolution attenuation, as the JAX package's fused routes do;
        # its XLA path returns it attenuated
        x = torch.from_numpy(imgs).float() / (255.0 if dtype == "uint8" else 1.0)
        got = pm.attenuation.heatmaps(x) * got
    np.testing.assert_allclose(to_np(got), want, atol=PREDS_ATOL)
    assert np.array_equal(t["msgs"].numpy(), np.asarray(j["msgs"]))
    changed = (t["imgs_w"].numpy() != imgs).mean()
    assert changed > 0.1, changed


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_unclamped_embed_matches_jax(models, dtype):
    """clamp=False leaves the kernel routes for heatmaps * prediction and the
    blend, and returns it neither rounded nor clipped: f32 for u8 frames too,
    on the 0..255 scale."""
    jv, pm = _pair(models, "lum", "repeat", clamp=False)
    try:
        imgs = _frames(dtype, 3, seed=11)
        msgs = np.random.default_rng(4).integers(0, 2, (3, NBITS)).astype(np.int32)
        launches = fused_blend.fused_jnd_delta_up.launches
        want = np.asarray(jv.embed(jnp.asarray(imgs), msgs=jnp.asarray(msgs))["imgs_w"])
        got = pm.embed(torch.from_numpy(imgs), msgs=torch.from_numpy(msgs).long())["imgs_w"]
    finally:
        _pair(models, "lum", "repeat")
    assert fused_blend.fused_jnd_delta_up.launches == launches
    scale = 255.0 if dtype == "uint8" else 1.0
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == imgs.shape
    # FLOAT_ATOL on the [0, 1] scale
    np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_ATOL * scale)
    g = got.numpy()
    assert (g < 0.0).any() or (g > scale).any()   # nothing clipped it


@pytest.mark.parametrize("case", ["video_u8_repeat", "image_float"])
def test_detect_and_extract_message_match_jax(models, case):
    """detect and extract_message on the same watermarked frames (the JAX
    embed's output) on both sides."""
    _, _, is_video, n, mode, _ = CASES[case]
    _, j, _, pm = _embed_both(models, case)
    jv, _ = _pair(models, "lum", mode)
    frames = np.array(j["imgs_w"])   # a writable copy for torch.from_numpy
    want = np.asarray(jv.detect(jnp.asarray(frames))["preds"])
    got = pm.detect(torch.from_numpy(frames))["preds"]
    assert tuple(got.shape) == want.shape == (n, 1 + NBITS)
    np.testing.assert_allclose(to_np(got), want, atol=LOGIT_ATOL)
    bits_want = np.asarray(jv.extract_message(jnp.asarray(frames)))
    bits = pm.extract_message(torch.from_numpy(frames)).numpy()
    assert bits.shape == bits_want.shape == (1, NBITS)
    clear = np.abs(want[:, 1:].mean(axis=0)) > 10 * LOGIT_ATOL
    assert np.array_equal(bits[0][clear], bits_want[0][clear])


@pytest.mark.parametrize("card,dtype", [("lum", "uint8"), ("lum", "float32"),
                                        ("rgb", "float32")])
def test_zero_strength_is_identity(models, card, dtype):
    """scaling_w=0 leaves the frames unchanged on the K4 and K6 routes."""
    _, pm = _pair(models, card, "repeat")
    imgs = torch.from_numpy(_frames(dtype, 5, seed=9))
    sw = pm.scaling_w
    pm.scaling_w = 0.0
    try:
        out = pm.embed(imgs, is_video=True)["imgs_w"]
    finally:
        pm.scaling_w = sw
    assert out.dtype == imgs.dtype and torch.equal(out, imgs)


def test_video_takes_one_message(models):
    _, pm = _pair(models, "lum", "repeat")
    with pytest.raises(ValueError, match="one row"):
        pm.embed(torch.zeros((4, H, W, 3), dtype=torch.uint8),
                 msgs=torch.zeros((2, NBITS), dtype=torch.long), is_video=True)


def test_random_messages_repeat():
    from videoseal_tpu_torch.modules.msg_processor import get_random_msg
    m = get_random_msg(NBITS, 3, nb_repetitions=4, generator=torch.Generator().manual_seed(0))
    assert tuple(m.shape) == (3, NBITS)
    q = NBITS // 4
    for k in range(1, 4):
        assert torch.equal(m[:, k * q:(k + 1) * q], m[:, :q])
    with pytest.raises(ValueError, match="multiple"):
        get_random_msg(NBITS, 1, nb_repetitions=3)
