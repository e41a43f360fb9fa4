"""The VAE, DVMark and DINO models of the port against the JAX package on
the CPU: the bicubic resize matrices bit for bit, the VAE encoder, decoder
and embedder (with and without attention, bw, tanh_out, odd and even
sizes), DVMark's encoder, decoder, embedder and extractor over 1, 3 and 8
frames with one message or one per frame, DINO at its position grid and an
interpolated one with negative hooks, each family's ``.npz`` round trip,
and a tiny card of each through ``VideoSeal.embed/detect`` (DVMark's with
the padded last chunk). Same weights on both sides (``jax_random_vars``
through ``from_jax_variables``); the JAX oracles run jitted at XLA's
backend level 0."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port import LOGIT_ATOL, NBITS, jax_model_random, jax_random_vars, port_model, to_np

from videoseal_tpu.models.embedder import build_embedder as jbuild_embedder
from videoseal_tpu.models.extractor import build_extractor as jbuild_extractor
from videoseal_tpu.modules import dino as jdino, vae as jvae
from videoseal_tpu.ops import resize as jresize
from videoseal_tpu_torch.models.embedder import build_embedder
from videoseal_tpu_torch.models.extractor import build_extractor
from videoseal_tpu_torch.modules import dino, dvmark, vae
from videoseal_tpu_torch.ops import resize
from videoseal_tpu_torch.utils import checkpoint as pckpt
from videoseal_tpu_torch.utils.convert import (embedder_from_jax, extractor_from_jax,
                                               from_jax_variables, to_jax_variables)

torch.set_num_threads(1)

# f32 on both sides: the convolutions' and matmuls' sums in another order;
# relative to the outputs' size where they are unnormalised
F32_ATOL, F32_RTOL = 5e-5, 1e-4
JAX_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    """fn(*args) through jax.jit at XLA's backend level 0, as numpy."""
    return np.asarray(jax.jit(fn).lower(*args).compile(JAX_COMPILE_OPTIONS)(*args))


def _close(got, want, atol=F32_ATOL, rtol=F32_RTOL):
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=atol, rtol=rtol)


def _imgs(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _msgs(n, seed=1):
    return np.random.default_rng(seed).integers(0, 2, (n, NBITS)).astype(np.int32)


def _same_tree(a, b):
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert [p for p, _ in fa] == list(fb), "trees differ in their paths"
    for p, x in fa:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(fb[p]), err_msg=str(p))


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# -- the bicubic resize ---------------------------------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(37, 18), (37, 16), (18, 37), (37, 73), (5, 3), (6, 6)])
def test_cubic_matrix_bit_equal(n_in, n_out):
    """`_cubic_matrix` equals the JAX package's bit for bit, and
    `resize_bicubic` its resize within float32 rounding."""
    np.testing.assert_array_equal(resize._cubic_matrix(n_in, n_out),
                                  jresize._cubic_matrix(n_in, n_out))
    x = _imgs((2, n_in, n_in + 1, 4))
    want = np.asarray(jresize.resize_bicubic(jnp.asarray(x), n_out, n_out + 2))
    _close(resize.resize_bicubic(torch.from_numpy(x), n_out, n_out + 2), want, 1e-6, 1e-6)


# -- the VAE --------------------------------------------------------------------------

def _vae_cfg(attn=True, bw=False, tanh=True, mp="binary+concat", double_z=True) -> dict:
    common = {"ch": 16, "out_ch": 3, "num_res_blocks": 1, "resolution": 16,
              "ch_mult": [1, 2], "attn_resolutions": [8] if attn else []}
    return {"msg_processor": {"msg_processor_type": mp},
            "encoder": dict(common, z_channels=4, double_z=double_z),
            "decoder": dict(common, z_channels=NBITS * 2 + 4, tanh_out=tanh, bw=bw)}


@pytest.mark.parametrize("attn", [True, False])
@pytest.mark.parametrize("size", [16, 17])
def test_vae_encoder(attn, size):
    """The encoder (attention at 8 px: both level-1 blocks and the middle)
    at an even and an odd size; the odd size floors through the (0, 1, 0,
    1) pad and the VALID stride-2 conv."""
    cfg = _vae_cfg(attn)["encoder"]
    jm = jvae.VAEEncoder(**cfg)
    x = _imgs((2, size, size, 3)) * 2 - 1
    v = jax_random_vars(jm, jnp.zeros((1, size, size, 3)))
    m = vae.VAEEncoder(**cfg)
    m.load_state_dict(_sub(embedder_from_jax({"params": {"encoder": v["params"]}}), "encoder."))
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, _jit(lambda vv, a: jm.apply(vv, a), v, x))
    assert got.shape[1] == (size + 1 - 3) // 2 + 1


@pytest.mark.parametrize("attn,bw,tanh", [(True, False, True), (False, True, False),
                                          (True, True, True)])
@pytest.mark.parametrize("size", [8, 7])
def test_vae_decoder(attn, bw, tanh, size):
    """The decoder (attention at its 8-px input when asked), the nearest 2x
    upsample, `bw` (one channel tiled to three) and `tanh_out`."""
    cfg = dict(_vae_cfg(attn, bw, tanh)["decoder"], z_channels=6)
    jm = jvae.VAEDecoder(**cfg)
    z = np.random.default_rng(2).normal(0, 1, (2, size, size, 6)).astype(np.float32)
    v = jax_random_vars(jm, jnp.zeros((1, size, size, 6)))
    m = vae.VAEDecoder(**cfg)
    m.load_state_dict(_sub(embedder_from_jax({"params": {"decoder": v["params"]}}), "decoder."))
    got = m(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, _jit(lambda vv, a: jm.apply(vv, a), v, z))
    assert got.shape == (2, 2 * size, 2 * size, 3)
    if bw:
        assert torch.equal(got[..., 0], got[..., 2])


def _embedder_pair(name, cfg, size, seed=0):
    """(JAX spec, its random variables, port spec holding them)."""
    jspec = jbuild_embedder(name, copy.deepcopy(cfg), NBITS, 2.0)
    c = 1 if jspec.yuv else 3
    v = jax_random_vars(jspec.module, jnp.zeros((1, size, size, c)), jnp.zeros((1, NBITS)),
                        seed=seed)
    spec = build_embedder(name, copy.deepcopy(cfg), NBITS, 2.0)
    spec.module.load_state_dict(embedder_from_jax(v))
    return jspec, v, spec


@pytest.mark.parametrize("name,kw", [("vae_small", {}), ("vae_small_yuv", {"attn": False}),
                                     ("vae_bw", {"bw": True, "tanh": False}),
                                     ("vae_single_z", {"double_z": False})])
def test_vae_embedder(name, kw):
    """x*2-1, the encoder, the message concatenated in the latent (its
    width 2z + hidden with double_z, z + hidden without), the decoder."""
    jspec, v, spec = _embedder_pair(name, _vae_cfg(**kw), 16)
    c = 1 if jspec.yuv else 3
    x, m = _imgs((2, 16, 16, c)), _msgs(2)
    want = _jit(lambda vv, a, b: jspec.module.apply(vv, a, b), v, x, m)
    got = spec.module(torch.from_numpy(x), torch.from_numpy(m))
    _close(got, want)
    z = 4 * (1 if kw.get("double_z") is False else 2)
    assert spec.module.decoder.conv_in.in_channels == z + 2 * NBITS
    assert spec.yuv == jspec.yuv and spec.out_channels == jspec.out_channels


# -- DVMark ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,m_rows", [(1, 1), (3, 3), (3, 1), (8, 1), (8, 8)])
def test_dvmark_embedder(f, m_rows):
    """The 3D-conv encoder over F frames as one video, with one message
    (broadcast from row 0) or one per frame, at an odd size (the VALID pool
    floors 15 to 7, the bilinear resize brings it back)."""
    jspec, v, spec = _embedder_pair("dvmark", {}, 15)
    x, m = _imgs((f, 15, 15, 3), seed=f), _msgs(m_rows, seed=m_rows)
    want = _jit(lambda vv, a, b: jspec.module.apply(vv, a, b), v, x, m)
    got = spec.module(torch.from_numpy(x), torch.from_numpy(m))
    _close(got, want)
    assert got.shape == (f, 15, 15, 3)


@pytest.mark.parametrize("f", [1, 3, 8])
def test_dvmark_extractor(f):
    """The 3D-conv decoder on the [0, 1] frames (no x*2-1), its mean over
    space: (F, 1 + nbits)."""
    jspec = jbuild_extractor("dvmark", {}, 16, NBITS)
    v = jax_random_vars(jspec.module, jnp.zeros((1, 16, 16, 3)))
    spec = build_extractor("dvmark", {}, 16, NBITS)
    spec.module.load_state_dict(extractor_from_jax(v))
    x = _imgs((f, 16, 16, 3), seed=10 + f)
    got = spec.module(torch.from_numpy(x))
    _close(got, _jit(lambda vv, a: jspec.module.apply(vv, a), v, x))
    assert got.shape == (f, NBITS + 1) and not spec.pixelwise


def test_dvmark_modules_mix_frames():
    """Both modules mark themselves as mixing frames, so the pipeline pads a
    short last chunk as JAX's lax.map does."""
    from videoseal_tpu_torch.modules.common import mixes_frames
    assert mixes_frames(dvmark.DVMarkEncoder(NBITS)) and mixes_frames(dvmark.DVMarkDecoder(NBITS))


# -- DINO -----------------------------------------------------------------------------

@pytest.mark.parametrize("size,hooks", [(56, (1, -1)), (42, (-4, 2, 3)), (45, (3,))])
def test_dino_vit(size, hooks):
    """DinoViT at tiny widths (D 32, depth 4, pos_grid 4): at 56 px the grid
    equals pos_grid (no resize), at 42 and 45 px (a 3x3 grid; 45 drops its
    last 3 px) the table is resized bicubically; hooks mod depth, cls
    dropped, the final norm on each."""
    kw = dict(embed_dim=32, depth=4, num_heads=2, pos_grid=4, hook_indices=hooks)
    jm = jdino.DinoViT(**kw)
    v = jax_random_vars(jm, jnp.zeros((1, size, size, 3)))
    m = dino.DinoViT(**kw)
    _, sd = from_jax_variables({"params": {}}, {"params": {"encoder": v["params"]}})
    m.load_state_dict(_sub(sd, "image_encoder."))
    x = _imgs((2, size, size, 3)) * 2 - 1
    got = m(torch.from_numpy(x))
    _close(got, _jit(lambda vv, a: jm.apply(vv, a), v, x))
    assert got.shape == (2, size // 14, size // 14, 32 * len(hooks))


def test_dino_extractor_vits14():
    """build_extractor("dino2...") at dinov2_vits14's width (hooks 2 and -1,
    a pixelwise head), the pixel decoder's embed_dim len(hooks) * 384."""
    cfg = {"encoder": {"name": "dinov2_vits14", "hook_indices": [2, -1]},
           "pixel_decoder": {"pixelwise": True, "upscale_stages": [2], "sigmoid_output": False}}
    jspec = jbuild_extractor("dino2s_indices", copy.deepcopy(cfg), 28, NBITS)
    v = jax_random_vars(jspec.module, jnp.zeros((1, 28, 28, 3)))
    spec = build_extractor("dino2s_indices", copy.deepcopy(cfg), 28, NBITS)
    spec.module.load_state_dict(extractor_from_jax(v))
    x = _imgs((2, 28, 28, 3))
    got = spec.module(torch.from_numpy(x))
    _close(got, _jit(lambda vv, a: jspec.module.apply(vv, a), v, x))
    assert got.shape == (2, 4, 4, NBITS + 1) and spec.pixelwise


# -- the .npz round trip ---------------------------------------------------------------

_ROUNDTRIP = {   # family: (builder kind, name, config, input size)
    "vae": ("embedder", "vae_small", _vae_cfg(), 16),
    "dvmark_embedder": ("embedder", "dvmark", {}, 8),
    "dvmark_extractor": ("extractor", "dvmark", {}, 8),
    "dino": ("extractor", "dino2s", {}, 28),
}


@pytest.mark.parametrize("family", list(_ROUNDTRIP))
def test_npz_roundtrip_exact(family, tmp_path):
    """JAX variables -> state dict -> JAX variables is the identity on the
    tree and its bits, and save_npz of a port model holding them writes
    that tree where the JAX package's load_npz reads it."""
    from types import SimpleNamespace

    from videoseal_tpu.utils.checkpoint import load_npz as jload_npz
    kind, name, cfg, s = _ROUNDTRIP[family]
    if kind == "embedder":
        jm = jbuild_embedder(name, copy.deepcopy(cfg), NBITS, 2.0).module
        v = jax_random_vars(jm, jnp.zeros((1, s, s, 3)), jnp.zeros((1, NBITS)), seed=3)
        module = build_embedder(name, copy.deepcopy(cfg), NBITS).module
        module.load_state_dict(embedder_from_jax(v))
        model = SimpleNamespace(embedder=module, extractor=torch.nn.Module())
    else:
        jm = jbuild_extractor(name, copy.deepcopy(cfg), s, NBITS).module
        v = jax_random_vars(jm, jnp.zeros((1, s, s, 3)), seed=3)
        module = build_extractor(name, copy.deepcopy(cfg), s, NBITS).module
        module.load_state_dict(extractor_from_jax(v))
        model = SimpleNamespace(embedder=torch.nn.Module(), extractor=module)
    back = to_jax_variables(model.embedder.state_dict(), model.extractor.state_dict())
    _same_tree(v, back[kind == "extractor"])
    path = str(tmp_path / "m.npz")
    pckpt.save_npz(path, model)
    _same_tree(v, jload_npz(path)[kind == "extractor"])


# -- tiny cards through the pipeline ----------------------------------------------------

def _card(embedder: tuple, extractor: tuple, img_size: int, chunk: int = 4) -> dict:
    return {
        "args": {"attenuation": "jnd_1_1", "nbits": NBITS, "hidden_size_multiplier": 2,
                 "img_size_proc": img_size, "blending_method": "additive", "scaling_w": 0.2,
                 "scaling_i": 1.0, "videoseal_chunk_size": chunk, "videoseal_step_size": 2,
                 "video_mode": "repeat"},
        "embedder": {"model": embedder[0], "params": embedder[1]},
        "extractor": {"model": extractor[0], "params": extractor[1]}}


_TINY_CONVNEXT = ("convnext_tiny", {
    "encoder": {"depths": [1, 1, 1, 1], "dims": [8, 16, 32, 64]},
    "pixel_decoder": {"pixelwise": False, "upscale_stages": [1], "embed_dim": 64,
                      "sigmoid_output": False}})
_TINY_UNET = ("unet_tiny_yuv", {
    "msg_processor": {"msg_processor_type": "binary+concat"},
    "unet": {"in_channels": 1, "out_channels": 1, "z_channels": 4, "num_blocks": 1,
             "activation": "relu", "normalization": "batch", "z_channels_mults": [1, 2],
             "last_tanh": True}})
_DINO = ("dino2s_indices", {"encoder": {"name": "dinov2_vits14", "hook_indices": [0, -1]},
                            "pixel_decoder": {"upscale_stages": [1], "sigmoid_output": False}})
CARDS = {
    "vae": _card(("vae_small", _vae_cfg()), _TINY_CONVNEXT, 32),
    "dvmark": _card(("dvmark", {}), ("dvmark", {}), 16),
    "dino": _card(_TINY_UNET, _DINO, 28),
}


@pytest.mark.parametrize("kind", ["vae", "dvmark", "dino"])
def test_card_embed_detect(kind):
    """Each family's tiny card through VideoSeal.embed (float frames as a
    video: DVMark's and the VAE's 3-channel predictions take K6's route) and
    detect against the JAX package's; DVMark over 6 frames at chunk 4, so
    its last chunk is padded with frame 0 as JAX's lax.map pads it."""
    card = CARDS[kind]
    jm = jax_model_random(card)
    model = port_model(card, jm)
    f = 6 if kind == "dvmark" else 4
    frames = _imgs((f, 24, 40, 3), seed=5)
    msgs = _msgs(1, seed=6)
    want = jm.embed(jnp.asarray(frames), msgs=jnp.asarray(msgs), is_video=True)
    got = model.embed(torch.from_numpy(frames), msgs=torch.from_numpy(msgs), is_video=True)
    _close(got["imgs_w"], np.asarray(want["imgs_w"]), 1e-5, 0)
    wdet = np.asarray(jm.detect(want["imgs_w"])["preds"])
    gdet = to_np(model.detect(got["imgs_w"])["preds"])
    # the VAE card's ConvNeXt runs K2's plain version (bf16 inside)
    _close(gdet, wdet, LOGIT_ATOL if kind == "vae" else 1e-4, 0)
    assert gdet.shape == (f, NBITS + 1)
