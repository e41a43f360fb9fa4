"""The preset variants of the port against the JAX package on the CPU: the
Upsample forms and Downsample, the gaussian message type and add
aggregation, the UNet's up/down sampling and conv layers, the pixelwise
head, HiDDeN's encoder and decoder, each new preset at a tiny depth, every
preset's parameter tree at full width, the weight bridge both ways (and
the JAX package's reader of reference state dicts), loading by path, the
pixelwise predictions through detect, extract_message and evals.full, and
a training step with the pixelwise extractor and the 2p1d embedder. The
JAX oracles take random variables through ``jax.eval_shape`` and run
jitted."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port import (LOGIT_ATOL, NBITS, jax_model_random, jax_random_vars, port_model,
                        tiny_card, to_np)

import videoseal_tpu_torch as vt
from videoseal_tpu.models.embedder import build_embedder as jbuild_embedder
from videoseal_tpu.models.extractor import build_extractor as jbuild_extractor
from videoseal_tpu_torch import presets
from videoseal_tpu_torch.models.embedder import build_embedder
from videoseal_tpu_torch.models.extractor import build_extractor
from videoseal_tpu_torch.modules.msg_processor import get_random_msg
from videoseal_tpu_torch.utils.convert import from_jax_variables, to_jax_variables

torch.set_num_threads(1)

# f32 on both sides: the convolutions' and matmuls' sums in another order
F32_ATOL = 5e-5
GRAD_RTOL = 1e-4
S = 32
EMPTY = {"params": {"unet": {}}}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _imgs(n, c=3, s=S, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, s, s, c)).astype(np.float32)


def _msgs(n, seed=1):
    return np.random.default_rng(seed).integers(0, 2, (n, NBITS)).astype(np.int32)


def _assert_same_tree(a, b):
    """Two variable trees with the same paths and bit-equal leaves."""
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert [p for p, _ in fa] == list(fb), "trees differ in their paths"
    for p, x in fa:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(fb[p]), err_msg=str(p))


def _embedder_pair(name, cfg, nbits=NBITS, mult=2.0, seed=0):
    """(JAX spec, its random variables, port spec holding them)."""
    jspec = jbuild_embedder(name, copy.deepcopy(cfg), nbits, mult)
    c = 1 if jspec.yuv else 3
    v = jax_random_vars(jspec.module, jnp.zeros((2, S, S, c)), jnp.zeros((2, nbits)), seed=seed)
    spec = build_embedder(name, copy.deepcopy(cfg), nbits, mult)
    sd, _ = from_jax_variables(v, {"params": {}})
    spec.module.load_state_dict(sd)
    spec.module.eval()
    return jspec, v, spec


def _extractor_pair(name, cfg, seed=0, size=S):
    jspec = jbuild_extractor(name, copy.deepcopy(cfg), size, NBITS)
    v = jax_random_vars(jspec.module, jnp.zeros((2, size, size, 3)), seed=seed)
    spec = build_extractor(name, copy.deepcopy(cfg), size, NBITS)
    _, sd = from_jax_variables(EMPTY, v)
    spec.module.load_state_dict(sd)
    spec.module.eval()
    return jspec, v, spec


def _unet(**kw):
    mp = kw.pop("mp", "binary+concat")
    unet = dict(in_channels=1, out_channels=1, z_channels=8, num_blocks=1, activation="relu",
                normalization="batch", z_channels_mults=[1, 2], last_tanh=True)
    return {"msg_processor": {"msg_processor_type": mp}, "unet": dict(unet, **kw)}


UNETS = {
    "conv2p1d": _unet(conv_layer="conv2p1d"),
    "conv3d": _unet(conv_layer="conv3d"),
    "pixelshuffle": _unet(upsampling_type="pixelshuffle", downsampling_type="pixelshuffle"),
    "convT": _unet(upsampling_type="conv", activation="gelu", normalization="group"),
    "nearest": _unet(upsampling_type="nearest", normalization="layer", activation="silu"),
    # add: the message's hidden width is the latent's (16 = 8 bits x 2)
    "gaussian_add": _unet(mp="gaussian+add", normalization="rms"),
}


@pytest.mark.parametrize("case", list(UNETS))
def test_unet_variants_match_linen(case):
    """The UNet's up/down sampling types, conv layers and message types
    against the linen module, 4 frames as one clip, and the weight bridge's
    round trip bit for bit."""
    gauss = case.startswith("gaussian")
    nbits = 8 if gauss else NBITS
    jspec, v, spec = _embedder_pair("unet_tiny_yuv", UNETS[case], nbits=nbits)
    x = _imgs(4, 1, seed=2)
    if gauss:
        m = to_np(get_random_msg(nbits, 4, generator=torch.Generator().manual_seed(3),
                                 msg_type="gaussian"))
    else:
        m = _msgs(4)
    want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x), jnp.asarray(m)))
    with torch.no_grad():
        got = spec.module(_t(x), torch.as_tensor(m))
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL)
    norm = UNETS[case]["unet"]["normalization"]
    back, _ = to_jax_variables(spec.module.state_dict(), {}, norm)
    _assert_same_tree(back, v)


def test_gaussian_messages():
    """get_random_msg(msg_type="gaussian"): unit rows from the generator,
    float32; binary stays int64 bits."""
    g = get_random_msg(16, 3, generator=torch.Generator().manual_seed(0), msg_type="gaussian")
    assert g.dtype == torch.float32 and tuple(g.shape) == (3, 16)
    np.testing.assert_allclose(to_np(torch.linalg.vector_norm(g, dim=-1)), 1.0, atol=1e-6)
    again = get_random_msg(16, 3, generator=torch.Generator().manual_seed(0), msg_type="gaussian")
    assert torch.equal(g, again)
    b = get_random_msg(16, 3, generator=torch.Generator().manual_seed(0))
    assert b.dtype == torch.int64 and set(b.unique().tolist()) <= {0, 1}


@pytest.mark.parametrize("upscale", ["nearest", "bilinear", "conv", "pixelshuffle"])
@pytest.mark.parametrize("pixelwise", [False, True])
def test_pixel_decoder_forms_match_linen(upscale, pixelwise):
    """Every Upsample form in the pixel decoder (stages 2, 2), with the mean
    pool and Linear head or pixelwise the 1x1 conv head (B, 4h, 4w, 1 + nbits)."""
    from videoseal_tpu.modules.pixel_decoder import PixelDecoder as JPD
    from videoseal_tpu_torch.modules.pixel_decoder import PixelDecoder
    kw = dict(embed_dim=32, nbits=NBITS, upscale_stages=(2, 2), upscale_type=upscale,
              pixelwise=pixelwise)
    feats = np.random.default_rng(4).normal(size=(3, 3, 5, 32)).astype(np.float32)
    lin = JPD(**kw)
    v = jax_random_vars(lin, jnp.asarray(feats), seed=5)
    want = np.asarray(jax.jit(lin.apply)(v, jnp.asarray(feats)))
    _, sd = from_jax_variables(EMPTY, {"params": {"pixel_decoder": v["params"]}})
    port = PixelDecoder(**kw)
    port.load_state_dict({k[len("pixel_decoder."):]: t for k, t in sd.items()})
    with torch.no_grad():
        got = port(_t(feats))
    assert tuple(got.shape) == want.shape == ((3, 12, 20, 17) if pixelwise else (3, 17))
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL)
    _, back = to_jax_variables({}, sd)
    _assert_same_tree(back["params"]["pixel_decoder"], v["params"])


def test_pixelwise_head_grad_matches_jax():
    """The pixelwise decoder's input and weight gradients against jax.grad."""
    from videoseal_tpu.modules.pixel_decoder import PixelDecoder as JPD
    from videoseal_tpu_torch.modules.pixel_decoder import PixelDecoder
    kw = dict(embed_dim=32, nbits=NBITS, upscale_stages=(4, 2), pixelwise=True)
    feats = np.random.default_rng(6).normal(size=(2, 2, 3, 32)).astype(np.float32)
    w = np.random.default_rng(7).normal(size=(2, 16, 24, 17)).astype(np.float32)
    lin = JPD(**kw)
    v = jax_random_vars(lin, jnp.asarray(feats), seed=8)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(lin.apply({"params": p}, x) * w),
                              argnums=(0, 1)))(v["params"], jnp.asarray(feats))
    _, sd = from_jax_variables(EMPTY, {"params": {"pixel_decoder": v["params"]}})
    port = PixelDecoder(**kw)
    port.load_state_dict({k[len("pixel_decoder."):]: t for k, t in sd.items()})
    xt = _t(feats).requires_grad_(True)
    (port(xt) * _t(w)).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, atol=GRAD_RTOL * float(np.abs(want).max()))

    close(xt.grad, gx)
    close(port.linear.weight.grad[:, :, 0, 0].T, gp["linear"]["kernel"][0, 0])
    close(port.linear.bias.grad, gp["linear"]["bias"])
    close(port.output_upscaling[0].upsample_block[2].weight.grad.permute(2, 3, 1, 0),
          gp["up_0"]["conv"]["kernel"])


# -- HiDDeN ----------------------------------------------------------------------------

def _hidden_cfg(kind: str, norm: str) -> dict:
    cfg = copy.deepcopy(presets.EMBEDDER["hidden"] if kind == "embedder"
                        else presets.EXTRACTOR["hidden"])
    return dict(cfg, num_blocks=2, z_channels=16, normalization=norm)


def test_hidden_embedder_preset_fault_in_jax():
    """The JAX package's build_embedder("hidden", preset) raises: its
    HiddenEmbedder takes num_blocks/channels/last_tanh, the preset the
    encoder's keys. The port builds the encoder from the preset."""
    with pytest.raises(TypeError, match="in_channels"):
        jbuild_embedder("hidden", presets.EMBEDDER["hidden"], NBITS)
    spec = build_embedder("hidden", presets.EMBEDDER["hidden"], NBITS)
    assert spec.out_channels == 3 and not spec.yuv
    assert len(spec.module.hidden_encoder.conv_bns) == 4


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_hidden_embedder_matches_encoder(norm):
    """The port's hidden embedder against JAX's HiddenEncoder applied
    directly, on imgs * 2 - 1 and the messages mapped to +-1; the weight
    bridge both ways."""
    from videoseal_tpu.modules.hidden import HiddenEncoder
    cfg = _hidden_cfg("embedder", norm)
    lin = HiddenEncoder(num_bits=NBITS, **cfg)
    x, m = _imgs(3, seed=9), _msgs(3, seed=10)
    xin, min_ = jnp.asarray(x * 2 - 1), jnp.asarray(2.0 * m - 1)
    v = jax_random_vars(lin, xin, min_, seed=11)
    want = np.asarray(jax.jit(lin.apply)(v, xin, min_))
    emb_vars = {c: {"hidden_encoder": t} for c, t in v.items()}
    spec = build_embedder("hidden", cfg, NBITS)
    sd, _ = from_jax_variables(emb_vars, {"params": {}})
    spec.module.load_state_dict(sd)
    spec.module.eval()
    with torch.no_grad():
        got = spec.module(_t(x), torch.as_tensor(m).long())
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL)
    back, _ = to_jax_variables(spec.module.state_dict(), {}, norm)
    _assert_same_tree(back, emb_vars)


@pytest.mark.parametrize("pixelwise", [False, True])
def test_hidden_extractor_matches_linen(pixelwise):
    cfg = dict(_hidden_cfg("extractor", "group"), pixelwise=pixelwise)
    jspec, v, spec = _extractor_pair("hidden", cfg, seed=12)
    x = _imgs(3, seed=13)
    want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x)))
    assert spec.pixelwise == pixelwise
    with torch.no_grad():
        got = spec.module(_t(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL)
    _, back = to_jax_variables({}, spec.module.state_dict(), "group")
    _assert_same_tree(back, v)


# -- the presets --------------------------------------------------------------------

def _tiny_extractor(name: str) -> dict:
    """The preset at a tiny depth and width (its layout kept)."""
    cfg = copy.deepcopy(presets.EXTRACTOR[name])
    if name.startswith("convnext"):
        cfg["encoder"].update(depths=[1, 1, 1, 1], dims=[8, 16, 32, 64])
        cfg["pixel_decoder"]["embed_dim"] = 64
    elif name.startswith("sam"):
        # 128 wide: the pixel decoder's last LayerNorm then has 8 channels
        cfg["encoder"].update(embed_dim=128, out_chans=128, depth=2, num_heads=2,
                              global_attn_indexes=[1], window_size=1)
        cfg["pixel_decoder"]["embed_dim"] = 128
    else:
        cfg.update(num_blocks=1, z_channels=16)
    return cfg


@pytest.mark.parametrize("name", ["convnext_tiny_pw", "convnext_tiny_temporal", "sam_small_pw",
                                  "hidden"])
def test_new_extractor_presets_match_jax(name):
    """Each new extractor preset at a tiny depth against the JAX package's
    build of it: the kernel route (K2's plain version rounds to bf16 inside)
    within LOGIT_ATOL, the other extractors in f32."""
    jspec, v, spec = _extractor_pair(name, _tiny_extractor(name), seed=14, size=64)
    x = _imgs(4, s=64, seed=15)
    want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = spec.module(_t(x))
    assert tuple(got.shape) == want.shape
    assert spec.pixelwise == name.endswith("_pw")
    np.testing.assert_allclose(to_np(got), want,
                               atol=LOGIT_ATOL if name.startswith("convnext") else 2e-4)


def test_2p1d_embedder_preset_matches_jax():
    """unet_small2_yuv_quant_2p1d at z_channels 4, one bottleneck block."""
    cfg = copy.deepcopy(presets.EMBEDDER["unet_small2_yuv_quant_2p1d"])
    cfg["unet"].update(z_channels=4, num_blocks=1)
    jspec, v, spec = _embedder_pair("unet_small2_yuv_quant_2p1d", cfg, seed=16)
    x, m = _imgs(4, 1, seed=17), _msgs(4, seed=18)
    want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x), jnp.asarray(m)))
    with torch.no_grad():
        got = spec.module(_t(x), torch.as_tensor(m).long())
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL)


PRESETS = ([("embedder", n) for n in presets.EMBEDDER if n != "model"]
           + [("extractor", n) for n in presets.EXTRACTOR if n != "model"])


@pytest.mark.parametrize("kind,name", PRESETS)
def test_every_preset_builds_with_jax_tree(kind, name):
    """Every preset builds in the port at its full width (16 bits), and its
    parameter tree through to_jax_variables is the JAX build's, path for
    path and shape for shape (the hidden embedder against JAX's
    HiddenEncoder: JAX's build of that preset raises)."""
    cfg = copy.deepcopy((presets.EMBEDDER if kind == "embedder" else presets.EXTRACTOR)[name])
    if kind == "embedder":
        spec = build_embedder(name, cfg, NBITS)
        if name == "hidden":
            from videoseal_tpu.modules.hidden import HiddenEncoder
            want = {"params": {"hidden_encoder": jax.eval_shape(
                HiddenEncoder(num_bits=NBITS, **cfg).init, jax.random.PRNGKey(0),
                jnp.zeros((1, S, S, 3)), jnp.zeros((1, NBITS)))["params"]}}
        else:
            jspec = jbuild_embedder(name, copy.deepcopy(cfg), NBITS)
            want = jax.eval_shape(jspec.module.init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, S, S, 1 if jspec.yuv else 3)),
                                  jnp.zeros((1, NBITS)))
        norm = cfg.get("unet", cfg).get("normalization", "batch")
        got, _ = to_jax_variables(spec.module.state_dict(), {}, norm)
        want = {c: t for c, t in dict(want).items() if c in ("params", "batch_stats")}
    else:
        spec = build_extractor(name, copy.deepcopy(cfg), 256, NBITS)
        jspec = jbuild_extractor(name, copy.deepcopy(cfg), 256, NBITS)
        want = {"params": jax.eval_shape(jspec.module.init, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 256, 256, 3)))["params"]}
        _, got = to_jax_variables({}, spec.module.state_dict(), cfg.get("normalization", "batch"))
    shapes = lambda t: {jax.tree_util.keystr(p): tuple(np.shape(a))
                        for p, a in jax.tree_util.tree_leaves_with_path(t)}
    assert shapes(got) == shapes(want)


# the models the port once refused, at small widths (no preset names them;
# tests/test_torch_vae_dvmark_dino.py holds each part in depth)
_VAE_WIDTHS = {"ch": 16, "out_ch": 3, "num_res_blocks": 1, "resolution": 32, "ch_mult": [1, 2],
               "attn_resolutions": [16]}
_ONCE_REFUSED = {
    "vae_small": {"msg_processor": {"msg_processor_type": "binary+concat"},
                  "encoder": dict(_VAE_WIDTHS, z_channels=4, double_z=True),
                  "decoder": dict(_VAE_WIDTHS, z_channels=2 * NBITS + 4, tanh_out=True)},
    "dvmark": {},
    "dino2s_indices": {"encoder": {"name": "dinov2_vits14", "hook_indices": [0, -1]},
                       "pixel_decoder": {"upscale_stages": [1], "sigmoid_output": False}},
}


@pytest.mark.parametrize("kind,name", [("embedder", "vae_small"), ("embedder", "dvmark"),
                                       ("extractor", "dino2s_indices"),
                                       ("extractor", "dvmark")])
def test_unported_models_raise(kind, name):
    """The VAE, DVMark and DINO models, which the port once refused (citing
    ROADMAP.md 1.9), build and match the linen modules at 32 px."""
    cfg = _ONCE_REFUSED[name]
    if kind == "embedder":
        jspec, v, spec = _embedder_pair(name, cfg)
        x, m = _imgs(3), _msgs(3)
        want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x), jnp.asarray(m)))
        with torch.no_grad():
            got = spec.module(_t(x), torch.as_tensor(m))
    else:
        jspec, v, spec = _extractor_pair(name, cfg)
        x = _imgs(3)
        want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x)))
        with torch.no_grad():
            got = spec.module(_t(x))
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL, rtol=1e-4)


# -- cards built from the presets -----------------------------------------------------

def _card(embedder: str, extractor: str, **emb_kw) -> dict:
    """tiny_card with the embedder and extractor presets' layouts at tiny
    widths."""
    card = tiny_card(img_size=64, step=2, chunk=4)
    if embedder.startswith("unet"):
        e = copy.deepcopy(presets.EMBEDDER[embedder])
        e["unet"].update(z_channels=4, num_blocks=1, z_channels_mults=[1, 2], **emb_kw)
    else:
        e = _hidden_cfg("embedder", "group")
    card["embedder"] = {"model": embedder, "params": e}
    card["extractor"] = {"model": extractor, "params": _tiny_extractor(extractor)}
    return card


@pytest.mark.parametrize("embedder,extractor,kw", [
    ("unet_small2_yuv_quant_2p1d", "convnext_tiny_temporal", {}),
    ("unet_small2_yuv_quant", "convnext_tiny_pw", {}),
    ("unet_small2_yuv_quant", "convnext_tiny", {"upsampling_type": "conv"}),
    ("unet_small2_yuv_quant", "convnext_tiny", {"upsampling_type": "pixelshuffle"}),
])
def test_convert_model_reads_port_state_dicts(embedder, extractor, kw):
    """The JAX package's converter of reference-named state dicts reads the
    port's: the same variables as to_jax_variables."""
    from videoseal_tpu.utils.torch_convert import convert_model
    card = _card(embedder, extractor, **kw)
    model = vt.VideoSeal.from_card(card, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jemb, jext = convert_model(sd, card)
    emb, ext = to_jax_variables(model.embedder.state_dict(), model.extractor.state_dict())
    _assert_same_tree(emb, jemb)
    _assert_same_tree(ext, jext)


@pytest.mark.parametrize("embedder,extractor", [
    ("unet_small2_yuv_quant_2p1d", "convnext_tiny_temporal"),
    ("unet_small2_yuv_quant", "convnext_tiny_pw"),
    ("hidden", "hidden"),
])
def test_load_by_path_names_the_presets(tmp_path, embedder, extractor):
    """A .npz whose args name the presets rebuilds them (full width) through
    vt.load, as the JAX package's get_config_from_checkpoint does, with the
    saved weights."""
    from videoseal_tpu.utils import cfg as jcfg
    from videoseal_tpu_torch.utils import cfg as pcfg
    args = {"embedder_model": embedder, "extractor_model": extractor, "nbits": NBITS,
            "img_size_proc": 64, "attenuation": "jnd_1_1", "scaling_w": 0.2}
    path = str(tmp_path / "m.npz")
    src = vt.VideoSeal.from_card({"args": dict(args, hidden_size_multiplier=2),
                                  "embedder": {"model": embedder, "params": copy.deepcopy(
                                      presets.EMBEDDER[embedder])},
                                  "extractor": {"model": extractor, "params": copy.deepcopy(
                                      presets.EXTRACTOR[extractor])}}, device="cpu", seed=3)
    vt.save_npz(path, src, args=args)
    assert pcfg.get_config_from_checkpoint(path) == jcfg.get_config_from_checkpoint(path)
    # the file's extractor tree is the JAX build's (HiDDeN's norms named by type)
    from videoseal_tpu.utils.checkpoint import load_npz as jload_npz
    jspec = jbuild_extractor(extractor, copy.deepcopy(presets.EXTRACTOR[extractor]), 64, NBITS)
    want = jax.eval_shape(jspec.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    paths = lambda t: sorted(jax.tree_util.keystr(p) for p, _ in
                             jax.tree_util.tree_leaves_with_path(t))
    assert paths(jload_npz(path)[1]["params"]) == paths(want["params"])
    got = vt.load(path, device="cpu")
    assert got.card["embedder"]["model"] == embedder
    for k, v in src.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    preds = got.detect(torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(0)))[
        "preds"]
    assert tuple(preds.shape) == ((2, 32, 32, 1 + NBITS) if extractor.endswith("_pw")
                                  else (2, 1 + NBITS))


# -- pixelwise predictions through the pipeline and the eval ------------------------------

@pytest.fixture(scope="module")
def pixelwise_models():
    card = _card("unet_small2_yuv_quant", "convnext_tiny_pw")
    jm = jax_model_random(card, seed=30)
    return jm, port_model(card, jm)


def test_pixelwise_detect_and_extract_message(pixelwise_models):
    """detect's (F, s, s, 1 + nbits) maps against JAX's elementwise;
    extract_message averages them spatially first, as JAX's does: the bits
    agree but where JAX's mean logit lies within the tolerance of 0."""
    jm, pm = pixelwise_models
    x = _imgs(6, s=80, seed=31)
    want = np.asarray(jm.detect(x)["preds"])
    got = to_np(pm.detect(_t(x))["preds"])
    # 64 px in: the ConvNeXt's 2x2 grid upscaled 16x
    assert got.shape == want.shape == (6, 32, 32, 1 + NBITS)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
    jbits = np.asarray(jm.extract_message(x))
    pbits = to_np(pm.extract_message(_t(x)))
    mean = want.mean(axis=(0, 1, 2))[1:]
    sure = np.abs(mean) > LOGIT_ATOL
    np.testing.assert_array_equal(pbits[0][sure], jbits[0][sure])


def test_pixelwise_through_evals_full(pixelwise_models):
    """evals.full.evaluate on a pixelwise card: bit_acc from preds[..., 1:]
    and the localisation columns from the detection map."""
    from videoseal_tpu_torch.augmentation.validation import get_validation_augs
    from videoseal_tpu_torch.evals.full import evaluate
    _, pm = pixelwise_models
    augs = [a for a in get_validation_augs(False, only_identity=True)]
    rows = evaluate(pm, [_imgs(2, s=64, seed=32)], validation_augs=augs, verbose=False,
                    bdrate=False)
    assert rows and all(0.0 <= r["bit_acc"] <= 1.0 for r in rows)
    assert any(k.startswith(("iou", "acc", "f1")) or "loc" in k for k in rows[0])


def test_pixelwise_2p1d_train_step(tmp_path):
    """--extractor_model convnext_tiny_pw with --embedder_model
    unet_small2_yuv_quant_2p1d at full width (64 px): train.main's image
    step, then the video step on an 8-frame clip; the pixelwise extractor
    takes the loss's masked decode branch. Losses finite, weights moved."""
    from videoseal_tpu_torch import train
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    flags = ["--device", "cpu", "--tiny", "1", "--img_size", "64", "--batch_size", "2",
             "--extractor_model", "convnext_tiny_pw",
             "--embedder_model", "unet_small2_yuv_quant_2p1d"]
    state, logger, _ = train.main(flags + ["--synthetic", "1", "--steps", "1", "--eval_freq",
                                           "0", "--tensorboard", "0",
                                           "--output_dir", str(tmp_path)])
    assert state.step == 1 and "loss_decode" in logger.meters
    assert all(np.isfinite(m.global_avg) for m in logger.meters.values())
    mods, st, _ = train.build_trainer(train.get_parser().parse_args(flags), torch.device("cpu"))
    assert mods.extractor.pixel_decoder.pixelwise
    before = {k: v.clone() for k, v in st.embedder.state_dict().items()}
    clip = torch.rand((1, 8, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    _, logs = make_train_step(mods, is_video=True)(st, {"imgs": clip},
                                                   torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(v)) for v in logs.values())
    assert any(not torch.equal(v, st.embedder.state_dict()[k]) for k, v in before.items())


def test_intrain_eval_pixelwise_matches_jax():
    """The in-training eval with a pixelwise extractor (the identity row, a
    half mask, lambda_det 1) against JAX's on the same weights, images and
    messages: bit accuracy under the mask, and the detection channel's pixel
    accuracy and mean IoU, equal but for the bits and pixels whose JAX
    logit lies within LOGIT_ATOL of 0; PSNR and SSIM within 1e-4."""
    import types

    from videoseal_tpu.augmentation.augmenter import get_dummy_augmenter as jdummy
    from videoseal_tpu.evals.intrain import make_intrain_eval as jax_eval
    from videoseal_tpu.models.videoseal import PipelineConfig as JCfg
    from videoseal_tpu.modules.jnd import JND as JJND
    from videoseal_tpu.parallel.trainer import TrainerModules as JMods
    from videoseal_tpu.parallel.trainer import TrainState
    from videoseal_tpu_torch.augmentation.augmenter import get_dummy_augmenter
    from videoseal_tpu_torch.evals.intrain import make_intrain_eval
    from videoseal_tpu_torch.models.videoseal import PipelineConfig
    from videoseal_tpu_torch.modules.jnd import JND
    from videoseal_tpu_torch.parallel.trainer import TrainerModules
    card = _card("unet_small2_yuv_quant", "convnext_tiny_pw")
    emb_cfg, ext_cfg = card["embedder"]["params"], card["extractor"]["params"]
    jemb, ev, emb = _embedder_pair("unet_small2_yuv_quant", emb_cfg, seed=40)
    jext, xv, ext = _extractor_pair("convnext_tiny_pw", ext_cfg, seed=41, size=64)
    jmods = JMods(embedder=jemb.module, extractor=jext.module, discriminator=None,
                  augmenter=jdummy(), attenuation=JJND(),
                  cfg=JCfg(img_size=64, yuv=True, nbits=NBITS), loss=None)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), embedder_params=ev["params"],
                        embedder_stats=ev["batch_stats"], extractor_params=xv["params"],
                        disc_params=None, opt_state_g=None, opt_state_d=None,
                        scaling_w=jnp.float32(0.2))
    mask = np.zeros((64, 64, 1), np.float32)
    mask[:, :32] = 1.0
    imgs = _imgs(3, s=64, seed=42)
    key = jax.random.PRNGKey(5)
    want, jimgs_w = jax_eval(jmods, eval_augs="identity", lambda_det=1.0,
                             validation_masks=[mask])(jstate, imgs, key)
    msgs = np.asarray(jax.random.randint(key, (3, NBITS), 0, 2))
    mods = TrainerModules(embedder=emb.module, extractor=ext.module, discriminator=None,
                          augmenter=get_dummy_augmenter(), attenuation=JND(),
                          cfg=PipelineConfig(img_size=64, yuv=True, nbits=NBITS), loss=None)
    state = types.SimpleNamespace(embedder=emb.module, extractor=ext.module, scaling_w=0.2)
    got, imgs_w = make_intrain_eval(mods, eval_augs="identity", lambda_det=1.0,
                                    validation_masks=[mask])(
        state, imgs, torch.Generator(), msgs=torch.from_numpy(msgs.astype(np.int64)))
    assert set(got) == set(want) == {"psnr", "ssim", "bit_acc_identity_0", "acc_identity_0",
                                     "miou_identity_0"}
    np.testing.assert_allclose(to_np(imgs_w), np.asarray(jimgs_w), atol=1e-5)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    jlogits = np.asarray(jext.module.apply(xv, jnp.asarray(jimgs_w)))
    unsure_bits = float((np.abs(jlogits[..., 1:]) < LOGIT_ATOL).mean())
    unsure_det = float((np.abs(jlogits[..., :1]) < LOGIT_ATOL).mean())
    assert abs(got["bit_acc_identity_0"] - want["bit_acc_identity_0"]) <= max(unsure_bits, 1e-6)
    assert abs(got["acc_identity_0"] - want["acc_identity_0"]) <= max(unsure_det, 1e-6)
    assert abs(got["miou_identity_0"] - want["miou_identity_0"]) <= max(4 * unsure_det, 1e-6)
