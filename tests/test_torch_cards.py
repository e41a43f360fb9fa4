"""The other three model cards in the port: videoseal_0.0 (SiLU and RMS
norms in its UNet, the SAM ViT extractor, no JND), pixelseal and chunkyseal
(stem at stride 2, widths that are not multiples of 16), against the JAX
package on the same weights (carried by from_jax_variables),
at narrow widths, f32; and all four cards built at full width with the JAX
models' parameter counts."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port import (LOGIT_ATOL, NBITS, jax_model, port_model, tiny_card, tiny_card_v0,
                        to_np)

from videoseal_tpu.kernels.fused_planar import pack_planar as jax_pack
from videoseal_tpu.modules import common as jcommon
from videoseal_tpu_torch import VideoSeal, load_card, pack_planar
from videoseal_tpu_torch.modules import common

torch.set_num_threads(1)

S = 64
# f32 convolutions and matmuls on both sides: summation order only
FLOAT_ATOL = 2e-5


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("kind", ["rms", "group", "layer"])
def test_norms_match_linen(kind):
    """make_norm's rms (ChanRMSNorm, gamma (C, 1, 1)), group and layer
    against the JAX Norm, through the weight bridge's names; one pixel all
    zero exercises RMS's floors."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    mod = jcommon.Norm(kind)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), v["params"])
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    norm = common.make_norm(kind, 16)
    from videoseal_tpu_torch.utils.convert import _convert, _flatten, _UNET
    sd = _convert(_flatten({"inc": {"norm1": params}}), _UNET)
    norm.load_state_dict({k[len("inc.double_conv.1."):]: t for k, t in sd.items()})
    if kind == "rms":
        assert tuple(norm.gamma.shape) == (16, 1, 1)
    with torch.no_grad():
        got = norm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", ["silu", "leakyrelu", "relu", "gelu"])
def test_activations_match_jax(name):
    x = np.random.default_rng(2).normal(size=(64,)).astype(np.float32) * 3
    want = np.asarray(jcommon.get_activation(name)(jnp.asarray(x)))
    got = common.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def v0():
    card = tiny_card_v0(img_size=S)
    jm = jax_model(card, seed=3)
    return jm, port_model(card, jm)


def test_v0_embedder_matches_linen(v0):
    """unet_small2 with SiLU and RMS norms, RGB in and out."""
    jm, pm = v0
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, S, S, 3)).astype(np.float32)
    m = rng.integers(0, 2, (3, NBITS)).astype(np.int32)
    want = np.asarray(jax.jit(jm.embedder_spec.module.apply)(
        jm.embedder_vars, jnp.asarray(x), jnp.asarray(m)))
    with torch.no_grad():
        got = pm.embedder(torch.from_numpy(x), torch.from_numpy(m).long())
    assert tuple(got.shape) == want.shape == (3, S, S, 3)
    np.testing.assert_allclose(to_np(got), want, atol=FLOAT_ATOL)


def test_v0_float_images_match_jax(v0):
    """Embed (no JND, scaling_w 1) and detect on float images."""
    jm, pm = v0
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 1, (2, 80, 96, 3)).astype(np.float32)
    msgs = rng.integers(0, 2, (2, NBITS)).astype(np.int32)
    j = jm.embed(imgs, msgs=jnp.asarray(msgs))
    t = pm.embed(torch.from_numpy(imgs), msgs=torch.from_numpy(msgs).long())
    assert tuple(t["preds_w"].shape) == np.shape(j["preds_w"]) == (2, 80, 96, 3)
    np.testing.assert_allclose(to_np(t["preds_w"]), np.asarray(j["preds_w"]), atol=FLOAT_ATOL)
    np.testing.assert_allclose(to_np(t["imgs_w"]), np.asarray(j["imgs_w"]), atol=FLOAT_ATOL)
    want = np.asarray(jm.detect(np.asarray(j["imgs_w"]))["preds"])
    got = to_np(pm.detect(t["imgs_w"])["preds"])
    assert got.shape == want.shape == (2, 1 + NBITS)
    # no ConvNeXt here: the ViT in f32 on both sides
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_v0_u8_video_matches_jax(v0):
    """A u8 video (7 frames, key frames every 2nd): the prediction within f32
    summation order, the u8 frames within one LSB where a sum lands at .5,
    and the blend itself the JAX package's bit for bit on the port's
    prediction; detect and extract_message on the result."""
    jm, pm = v0
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (7, 72, 88, 3), np.uint8)
    msgs = rng.integers(0, 2, (1, NBITS)).astype(np.int32)
    j = jm.embed(frames, msgs=jnp.asarray(msgs), is_video=True)
    t = pm.embed(torch.from_numpy(frames), msgs=torch.from_numpy(msgs).long(), is_video=True)
    np.testing.assert_allclose(to_np(t["preds_w"]), np.asarray(j["preds_w"]), atol=FLOAT_ATOL)
    got = t["imgs_w"]
    assert got.dtype == torch.uint8 and tuple(got.shape) == frames.shape
    d = np.abs(got.numpy().astype(np.int16) - np.asarray(j["imgs_w"]).astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    blend = jnp.clip(jnp.round(1.0 * jnp.asarray(frames).astype(jnp.float32)
                               + 255.0 * 1.0 * jnp.asarray(to_np(t["preds_w"]))), 0.0, 255.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(blend.astype(jnp.uint8)))
    jw = np.array(j["imgs_w"])
    want = np.asarray(jm.detect(jw)["preds"])
    np.testing.assert_allclose(to_np(pm.detect(torch.from_numpy(jw))["preds"]), want, atol=1e-4)
    bits = pm.extract_message(torch.from_numpy(jw))
    assert np.array_equal(bits.numpy(), np.asarray(jm.extract_message(jw)))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_v0_zero_strength_is_identity(v0, dtype):
    _, pm = v0
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (3, 40, 56, 3), np.uint8)
    imgs = torch.from_numpy(imgs if dtype == "uint8" else (imgs / 255.0).astype(np.float32))
    model = copy.copy(pm)
    model.scaling_w = 0.0
    assert torch.equal(model.embed(imgs, is_video=True)["imgs_w"], imgs)


def test_v0_planar_path_refused(v0):
    """Without JND the planar path is refused in both packages: the port
    raises ValueError, the JAX package asserts (AssertionError)."""
    jm, pm = v0
    frames = np.zeros((2, 32, 48, 3), np.uint8)
    with pytest.raises(ValueError, match="JND"):
        pm.embed_planar(pack_planar(torch.from_numpy(frames)), 32, 48)
    with pytest.raises(AssertionError):
        jm.embed_planar(jax_pack(frames), 32, 48)


def test_v0_npz_round_trip(tmp_path):
    """A videoseal_0.0 model written by the JAX package's save_npz loads
    through from_card(checkpoint=....npz): the carried tensors exactly, and
    the JAX model's logits on the same frames."""
    from videoseal_tpu.utils.checkpoint import save_npz
    card = tiny_card_v0(img_size=S)
    jm = jax_model(card, seed=8)
    path = str(tmp_path / "v0.npz")
    save_npz(path, jm.embedder_vars, jm.extractor_vars, args=card["args"])
    got = VideoSeal.from_card(copy.deepcopy(card), checkpoint=path, device="cpu", seed=9)
    want = port_model(card, jm)
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    frames = np.random.default_rng(10).uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    np.testing.assert_allclose(to_np(got.detect(torch.from_numpy(frames))["preds"]),
                               np.asarray(jm.detect(frames)["preds"]), atol=1e-4)


def _tiny_pixelseal() -> dict:
    """pixelseal's layout (unet_base_yuv_quant, luminance in and out,
    z_channels_mults [2, 4, ...], step 8, ConvNeXt extractor) at narrow widths."""
    card = tiny_card(img_size=S, step=8, chunk=4)
    card["embedder"]["model"] = "unet_base_yuv_quant"
    card["embedder"]["params"]["unet"]["z_channels_mults"] = [2, 4]
    return card


@pytest.fixture(scope="module")
def pixelseal():
    card = _tiny_pixelseal()
    jm = jax_model(card, seed=12)
    return jm, port_model(card, jm)


def test_pixelseal_nhwc_matches_jax(pixelseal):
    """A u8 video through embed (K4's blend mode, plain on the CPU) and
    detect (K2 at the ConvNeXt's widths)."""
    jm, pm = pixelseal
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, (9, 64, 80, 3), np.uint8)
    msgs = rng.integers(0, 2, (1, NBITS)).astype(np.int32)
    j = jm.embed(frames, msgs=jnp.asarray(msgs), is_video=True)
    t = pm.embed(torch.from_numpy(frames), msgs=torch.from_numpy(msgs).long(), is_video=True)
    d = np.abs(t["imgs_w"].numpy().astype(np.int16) - np.asarray(j["imgs_w"]).astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    jw = np.array(j["imgs_w"])
    want = np.asarray(jm.detect(jw)["preds"])
    got = to_np(pm.detect(torch.from_numpy(jw))["preds"])
    assert got.shape == want.shape == (9, 1 + NBITS)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


def test_pixelseal_planar_matches_jax(pixelseal):
    """embed_detect_planar in the scored mode (K1 with the detect output):
    the JAX side's Pallas kernel in interpret mode, the port's plain
    version."""
    jm, pm = pixelseal
    rng = np.random.default_rng(14)
    frames = rng.integers(0, 256, (9, 64, 80, 3), np.uint8)
    msgs = rng.integers(0, 2, (1, NBITS)).astype(np.int32)
    kw = dict(lowres_attenuation=True, fused_detect=False)
    j = jm.embed_detect_planar(jax_pack(frames), 64, 80, msgs=jnp.asarray(msgs),
                               interpret=True, **kw)
    t = pm.embed_detect_planar(pack_planar(torch.from_numpy(frames)), 64, 80,
                               msgs=torch.from_numpy(msgs).long(), **kw)
    d = np.abs(t["imgs_w"].numpy().astype(np.int16) - np.asarray(j["imgs_w"]).astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    np.testing.assert_allclose(to_np(t["preds"]), np.asarray(j["preds"]), atol=LOGIT_ATOL)


def _tiny_chunkyseal() -> dict:
    """chunkyseal's layout at narrow widths: RGB in and out, a ConvNeXt whose
    stem runs at stride 2 and whose dims [32, 64, 128, 256] scale by
    sqrt(16 / 128) to [11, 22, 45, 90] (odd widths, odd H*W at 64 px)."""
    card = tiny_card(img_size=S, step=8, chunk=4, out_channels=3)
    card["embedder"]["model"] = "unet_chunky"
    card["embedder"]["params"]["unet"]["z_channels_mults"] = [4, 8]
    card["extractor"] = {"model": "convnext_chunky", "params": {
        "proportional_dim": True,
        "encoder": {"stem_stride": 2, "depths": [1, 1, 1, 1], "dims": [32, 64, 128, 256]},
        "pixel_decoder": {"pixelwise": False, "upscale_stages": [1], "sigmoid_output": False}}}
    return card


def test_chunkyseal_matches_jax():
    """Float images through embed (K6's route, plain on the CPU) and detect
    (K2 at padded widths) against the JAX model."""
    card = _tiny_chunkyseal()
    jm = jax_model(card, seed=15)
    pm = port_model(card, jm)
    assert [st[0].dwconv.in_channels for st in pm.extractor.convnext.stages] == [11, 22, 45, 90]
    rng = np.random.default_rng(16)
    imgs = rng.uniform(0, 1, (2, 64, 80, 3)).astype(np.float32)
    msgs = rng.integers(0, 2, (2, NBITS)).astype(np.int32)
    j = jm.embed(imgs, msgs=jnp.asarray(msgs))
    t = pm.embed(torch.from_numpy(imgs), msgs=torch.from_numpy(msgs).long())
    np.testing.assert_allclose(to_np(t["imgs_w"]), np.asarray(j["imgs_w"]), atol=FLOAT_ATOL)
    jw = np.array(j["imgs_w"])
    want = np.asarray(jm.detect(jw)["preds"])
    got = to_np(pm.detect(torch.from_numpy(jw))["preds"])
    assert got.shape == want.shape == (2, 1 + NBITS)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


NAMES = ["videoseal_1.0", "pixelseal", "videoseal_0.0", "chunkyseal"]


def _jax_counts(name: str) -> tuple[int, int]:
    """The JAX model's parameter counts (embedder, extractor), from the
    shapes of its init (nothing allocated)."""
    from videoseal_tpu.models.embedder import build_embedder as jbe
    from videoseal_tpu.models.extractor import build_extractor as jbx
    card = load_card(name)
    a, e, x = card["args"], card["embedder"], card["extractor"]
    s = a["img_size_proc"]
    emb = jbe(e["model"], e["params"], a["nbits"], a["hidden_size_multiplier"])
    ext = jbx(x["model"], x["params"], s, a["nbits"])
    key = jax.random.PRNGKey(0)
    ev = jax.eval_shape(emb.module.init, key, jnp.zeros((1, s, s, 1 if emb.yuv else 3)),
                        jnp.zeros((1, a["nbits"]), jnp.int32))
    xv = jax.eval_shape(ext.module.init, key, jnp.zeros((1, s, s, 3)))
    count = lambda t: sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(t))
    return count(ev["params"]), count(xv["params"])


@pytest.mark.parametrize("name", NAMES)
def test_card_builds_at_full_width(name):
    """Each card's modules at its published widths, with the JAX model's
    parameter counts. videoseal_1.0, pixelseal and videoseal_0.0 build
    through from_card on the CPU; chunkyseal's 1.8e9 parameters (7 GB in
    f32) are built on the meta device, which allocates nothing."""
    from videoseal_tpu_torch.models.embedder import build_embedder
    from videoseal_tpu_torch.models.extractor import build_extractor
    card = load_card(name)
    if name == "chunkyseal":
        a, e, x = card["args"], card["embedder"], card["extractor"]
        with torch.device("meta"):
            emb = build_embedder(e["model"], e["params"], a["nbits"],
                                 a["hidden_size_multiplier"]).module
            ext = build_extractor(x["model"], x["params"], a["img_size_proc"], a["nbits"]).module
    else:
        model = VideoSeal.from_card(card, device="cpu")
        emb, ext = model.embedder, model.extractor
        assert model.nbits == card["args"]["nbits"]
        assert model.device.type == "cpu"
        assert (model.attenuation is None) == (card["args"]["attenuation"] is None)
    got = (sum(p.numel() for p in emb.parameters()), sum(p.numel() for p in ext.parameters()))
    assert got == _jax_counts(name)
