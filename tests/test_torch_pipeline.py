"""The port's planar serving slice against the JAX package end to end:
VideoSeal.embed_detect_planar in the scored mode (lowres attenuation, detect
input from inside the blend kernel) and in the card default (full-res JND,
separate planar resize for detect), then aggregate_message. The JAX side runs
its Pallas kernel in interpret mode; the port runs its plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port import LOGIT_ATOL, NBITS, jax_model, port_model, tiny_card, to_np

from videoseal_tpu.kernels.fused_planar import pack_planar as jax_pack
from videoseal_tpu.models.videoseal import aggregate_message as jax_aggregate
from videoseal_tpu_torch import aggregate_message, pack_planar

torch.set_num_threads(1)

F, H, W = 4, 160, 256
MODES = {"scored": dict(lowres_attenuation=True, fused_detect=True),
         "default": dict(lowres_attenuation=False, fused_detect=False)}


@pytest.fixture(scope="module")
def runs():
    card = tiny_card(img_size=128)
    jm = jax_model(card, seed=11)
    pm = port_model(card, jm)
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (F, H, W, 3), np.uint8)
    msgs = rng.integers(0, 2, (1, NBITS)).astype(np.int32)
    jp = jax_pack(imgs)
    tp = pack_planar(torch.from_numpy(imgs))
    out = {}
    for name, kw in MODES.items():
        j = jm.embed_detect_planar(jp, H, W, msgs=jnp.asarray(msgs), interpret=True, **kw)
        t = pm.embed_detect_planar(tp, H, W, msgs=torch.from_numpy(msgs).long(), **kw)
        out[name] = (j, t)
    return out, pm, tp, msgs


@pytest.mark.parametrize("mode", list(MODES))
def test_watermarked_frames(runs, mode):
    j, t = runs[0][mode]
    want = np.asarray(j["imgs_w"]).astype(np.int16)
    got = t["imgs_w"]
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (F, 3, 192, 256)
    d = np.abs(got.numpy().astype(np.int16) - want)
    # f32 sums in another order may flip a rounding at .5: within 1 LSB
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-3


@pytest.mark.parametrize("mode", list(MODES))
def test_logits(runs, mode):
    j, t = runs[0][mode]
    want = np.asarray(j["preds"])
    got = to_np(t["preds"])
    assert got.shape == want.shape == (F, 1 + NBITS)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_aggregate_message(runs, mode):
    """Bits agree wherever the mean bit logit is clear of the logit
    tolerance (random-init logits sit near 0)."""
    j, t = runs[0][mode]
    want = np.asarray(jax_aggregate(j["preds"]))
    got = aggregate_message(t["preds"]).numpy()
    assert got.shape == want.shape == (1, NBITS)
    clear = np.abs(np.asarray(j["preds"])[:, 1:].mean(axis=0)) > 10 * LOGIT_ATOL
    assert np.array_equal(got[0][clear], want[0][clear])


def test_zero_strength_is_identity(runs):
    _, pm, tp, msgs = runs
    sw = pm.scaling_w
    pm.scaling_w = 0.0
    try:
        out = pm.embed_planar(tp, H, W, msgs=torch.from_numpy(msgs).long(),
                              lowres_attenuation=True)["imgs_w"]
    finally:
        pm.scaling_w = sw
    assert torch.equal(out[:, :, :H, :W], tp[:, :, 28:28 + H, 128:128 + W])


@pytest.mark.parametrize("agg", ["avg", "squared_avg", "l1norm_avg", "l2norm_avg", "none"])
def test_aggregate_modes(agg):
    preds = np.random.default_rng(8).normal(size=(6, 1 + NBITS)).astype(np.float32)
    want = np.asarray(jax_aggregate(jnp.asarray(preds), agg))
    got = aggregate_message(torch.from_numpy(preds), agg).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["repeat", "alternate", "interpolate"])
@pytest.mark.parametrize("n,total", [(3, 12), (3, 10), (1, 4)])
def test_expand_video_mode(mode, n, total):
    from videoseal_tpu.models.videoseal import _expand_video_mode as jax_expand
    from videoseal_tpu_torch.models.videoseal import _expand_video_mode
    preds = np.random.default_rng(n).normal(size=(n, 5, 5, 1)).astype(np.float32)
    want = np.asarray(jax_expand(jnp.asarray(preds), total, 4, mode))
    got = _expand_video_mode(torch.from_numpy(preds), total, 4, mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)  # f32 linear mix, same formula


def test_fused_detect_needs_lane_aligned_size():
    from videoseal_tpu_torch import VideoSeal
    model = VideoSeal.from_card(tiny_card(img_size=64), device="cpu")
    tp = pack_planar(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="img_size % 128"):
        model.embed_detect_planar(tp, 64, 64, lowres_attenuation=True)
