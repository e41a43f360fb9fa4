"""The port's serving UNet (``kernels/unet_fused.py``) against the JAX
package's ``unet_apply_fused`` and against the port's own module, the rule
by which ``with_dtype`` routes there, the cache of the folded weights, and
the tiny card's ``with_dtype("bfloat16")`` slice against JAX's, whose
``cfg.fused_embedder`` is set on the CPU too.

Tolerances: float32 within 2e-4 (the JAX package's own parity bound,
tests/test_unet_fused.py). In bf16 both packages round every op, and a
tiny random UNet amplifies that (an rms norm over 4 channels most): the
port's bf16 output is held to the JAX package's own bf16 noise on the same
input, the distance of its bf16 forward from its float32 one. Its mean
|difference| stays within 1.5 times that distance's mean and its largest
within 2 times that distance's largest."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port import (LOGIT_ATOL, NBITS, _randomize, jax_model_random, jax_random_vars,
                        port_model, tiny_card)

from videoseal_tpu.kernels.unet_fused import supports_unet_fused as jax_supports
from videoseal_tpu.kernels.unet_fused import unet_apply_fused as jax_unet
from videoseal_tpu.models.embedder import UnetEmbedder as JaxUnetEmbedder
from videoseal_tpu.models.embedder import build_embedder as jax_build_embedder
from videoseal_tpu.models.extractor import build_extractor as jax_build_extractor
from videoseal_tpu.models.videoseal import PipelineConfig as JaxConfig
from videoseal_tpu.models.videoseal import VideoSeal as JaxVideoSeal
from videoseal_tpu_torch import VideoSeal, pack_planar, presets
from videoseal_tpu_torch.kernels.unet_fused import (_fold_bn, fused_params, supports_unet_fused,
                                                   unet_apply_fused)
from videoseal_tpu_torch.models import videoseal as vs_mod
from videoseal_tpu_torch.models.embedder import build_embedder
from videoseal_tpu_torch.models.videoseal import init_weights
from videoseal_tpu_torch.ops.color import rgb_to_y
from videoseal_tpu_torch.utils.convert import embedder_from_jax

torch.set_num_threads(1)

F32_ATOL = 2e-4
BF16_MEAN_FACTOR, BF16_MAX_FACTOR = 1.5, 2.0
NB, S = 8, 32
JAX_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}
# (normalization, activation, channels)
UNETS = [("batch", "relu", 1), ("batch", "relu", 3), ("rms", "silu", 1), ("rms", "silu", 3)]


def _unet_cfg(norm: str, act: str, c: int) -> dict:
    return {"msg_processor": {"msg_processor_type": "binary+concat"},
            "unet": {"in_channels": c, "out_channels": c, "z_channels": 4, "num_blocks": 2,
                     "activation": act, "normalization": norm, "z_channels_mults": [1, 2, 4],
                     "last_tanh": True}}


@pytest.fixture(scope="module", params=UNETS, ids=lambda u: f"{u[0]}-{u[1]}-c{u[2]}")
def unet(request):
    """One UNet in both packages with the same random weights (BatchNorm
    statistics and rms gains drawn with numpy), its inputs, and JAX's
    folded forward in float32 and bf16 (params cast first, as JAX's
    with_dtype casts them)."""
    norm, act, c = request.param
    name = "unet_x" + ("_yuv" if c == 1 else "")
    cfg = _unet_cfg(norm, act, c)
    js = jax_build_embedder(name, cfg, NB, 2)
    v = jax_random_vars(js.module, jnp.zeros((1, S, S, c)), jnp.zeros((1, NB), jnp.int32),
                        seed=len(request.param[0]) + c)
    v = _randomize(v, np.random.default_rng(7 + c))
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (3, S, S, c)).astype(np.float32)
    m = rng.integers(0, 2, (3, NB))
    kw = dict(nbits=NB, hidden_size=2 * NB, z_channels_mults=(1, 2, 4), activation=act,
              normalization=norm, num_blocks=2)
    fn = functools.partial(jax_unet, **kw)
    want = {}
    for dt in ("float32", "bfloat16"):
        vv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), v)
        args = (vv["params"], vv.get("batch_stats", {}), jnp.asarray(x, dt), jnp.asarray(m))
        want[dt] = np.asarray(jax.jit(fn).lower(*args).compile(JAX_COMPILE_OPTIONS)(*args),
                              np.float32)
    ts = build_embedder(name, cfg, NB, 2)
    ts.module.load_state_dict(embedder_from_jax(v))
    return ts.module.eval(), torch.from_numpy(x), torch.from_numpy(m), want


def _run(emb, x, m, dtype):
    mod = copy.deepcopy(emb).to(dtype)
    with torch.no_grad():
        return (unet_apply_fused(mod.unet, x.to(dtype), m).float().numpy(),
                mod(x.to(dtype), m).float().numpy())


def test_fused_matches_jax_f32(unet):
    emb, x, m, want = unet
    got, _ = _run(emb, x, m, torch.float32)
    assert got.shape == want["float32"].shape == tuple(x.shape)
    np.testing.assert_allclose(got, want["float32"], atol=F32_ATOL, rtol=0)


def test_fused_matches_jax_bf16(unet):
    emb, x, m, want = unet
    got, _ = _run(emb, x, m, torch.bfloat16)
    floor = np.abs(want["bfloat16"] - want["float32"])
    d = np.abs(got - want["bfloat16"])
    assert d.mean() <= BF16_MEAN_FACTOR * floor.mean(), (d.mean(), floor.mean())
    assert d.max() <= BF16_MAX_FACTOR * floor.max(), (d.max(), floor.max())


def test_fused_matches_module_f32(unet):
    emb, x, m, _ = unet
    got, ref = _run(emb, x, m, torch.float32)
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("msg_type", ["binary+add", "gaussian+concat", "gaussian+add"])
def test_fused_matches_module_other_messages(msg_type):
    """The message goes in through the module's MsgProcessor, so the message
    types that JAX's folded forward does not take (no preset uses them)
    still match the module."""
    cfg = _unet_cfg("batch", "relu", 1)
    cfg["msg_processor"]["msg_processor_type"] = msg_type   # latent and message 16 wide
    emb = build_embedder("unet_x_yuv", cfg, NB, 2).module
    init_weights(emb, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in emb.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    x = torch.rand((2, S, S, 1), generator=g)
    m = (torch.randn((2, NB), generator=g) if msg_type.startswith("gaussian")
         else torch.randint(0, 2, (2, NB), generator=g))
    got, ref = _run(emb.eval(), x, m, torch.float32)
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


# -- the route -----------------------------------------------------------------

_VARIANTS = [{"normalization": "group"}, {"normalization": "layer"},
             {"upsampling_type": "nearest"}, {"upsampling_type": "conv"},
             {"upsampling_type": "pixelshuffle"}, {"downsampling_type": "pixelshuffle"},
             {"conv_layer": "conv3d"}, {"conv_layer": "conv2p1d"}, {}]


def _preset_unets() -> dict:
    out = {}
    for name, params in presets.EMBEDDER.items():
        if isinstance(params, dict) and name.startswith("unet"):
            out[name] = params.get("unet", {})
    return out


def test_supports_matches_jax():
    cases = list(_preset_unets().values()) + _VARIANTS
    assert len(cases) > len(_VARIANTS)
    for u in cases:
        assert supports_unet_fused(u) == jax_supports(u), u


def _tiny_cards() -> dict:
    """Every UNet preset at tiny widths (its norm, conv, up and down
    sampling kept), and the variants on the tiny card's UNet."""
    base = tiny_card(img_size=64)
    cards = {}
    for name in _preset_unets():
        params = copy.deepcopy(presets.EMBEDDER[name])
        params["unet"].update(z_channels=4, num_blocks=1, z_channels_mults=[1, 2])
        cards[name] = dict(base, embedder={"model": name, "params": params})
    for i, v in enumerate(_VARIANTS):
        card = copy.deepcopy(base)
        card["embedder"]["params"]["unet"].update(v, z_channels=8)   # 8 groups
        cards[f"variant{i}"] = card
    return cards


@pytest.mark.parametrize("name", list(_tiny_cards()))
def test_with_dtype_sets_fused_embedder_as_jax(name):
    card = _tiny_cards()[name]
    a, e = card["args"], card["embedder"]
    jemb = jax_build_embedder(e["model"], e["params"], a["nbits"], a["hidden_size_multiplier"])
    jext = jax_build_extractor(card["extractor"]["model"], card["extractor"]["params"], 64,
                               a["nbits"])
    jm = JaxVideoSeal(jemb, jext, {}, {}, None, JaxConfig(img_size=64, nbits=a["nbits"]))
    want = jm.with_dtype("bfloat16").cfg.fused_embedder
    pm = VideoSeal.from_card(card, device="cpu")
    assert not pm.cfg.fused_embedder
    for dt in ("bfloat16", "float32"):
        assert pm.with_dtype(dt).cfg.fused_embedder == want
    assert want == (isinstance(jemb.module, JaxUnetEmbedder)
                    and jax_supports(jemb.module.unet))


# -- the cache, the keys and autograd ---------------------------------------------

def _small_model():
    card = tiny_card(img_size=64)
    model = VideoSeal.from_card(card, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mod in model.embedder.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    return model


def _inputs(n=2, seed=5, channels=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (n, 64, 64, channels)).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, 2, (n, NBITS)))


def test_cache_folds_anew():
    model = _small_model()
    unet = model.embedder.unet
    conv, bn = unet.inc.double_conv[0], unet.inc.double_conv[1]
    p = fused_params(unet)
    assert fused_params(unet) is p
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(p[conv], _fold_bn(conv.weight, bn)))
        bn.running_var.mul_(2.0)               # in-place update: _version moves
    q = fused_params(unet)
    assert q is not p and fused_params(unet) is q
    with torch.no_grad():
        assert torch.equal(q[conv][1], _fold_bn(conv.weight, bn)[1])
    x, m = _inputs()
    with torch.no_grad():
        np.testing.assert_allclose(unet_apply_fused(unet, x, m).numpy(),
                                   model.embedder(x, m).numpy(), atol=F32_ATOL, rtol=0)
    # load_state_dict copies in place
    sd = {k: v * 1.5 if k.endswith("running_mean") else v
          for k, v in model.embedder.state_dict().items()}
    model.embedder.load_state_dict(sd)
    r = fused_params(unet)
    assert r is not q
    with torch.no_grad():
        np.testing.assert_allclose(unet_apply_fused(unet, x, m).numpy(),
                                   model.embedder(x, m).numpy(), atol=F32_ATOL, rtol=0)
    # with_dtype: the copy folds its own, in bf16; the original keeps its own
    m16 = model.with_dtype("bfloat16")
    u16 = m16.embedder.unet
    s = fused_params(u16)
    assert s is not r and s[u16.inc.double_conv[0]][0].dtype == torch.bfloat16
    assert fused_params(unet) is r
    # .to: new storage and dtype
    unet.to(torch.float64)
    t = fused_params(unet)
    assert t is not r and t[conv][0].dtype == torch.float64


def test_state_dict_keys_and_autograd(monkeypatch):
    model = _small_model()
    m16 = model.with_dtype("float32")
    assert m16.cfg.fused_embedder
    keys = list(model.state_dict())
    calls = []
    real = vs_mod.unet_apply_fused
    monkeypatch.setattr(vs_mod, "unet_apply_fused",
                        lambda *a: calls.append(1) or real(*a))
    run = vs_mod._make_run_embedder(m16.embedder, m16.cfg)
    x, m = _inputs(channels=3)       # RGB frames: the card's embedder takes their Y
    with torch.no_grad():
        got = run((x, m))
    assert calls == [1] and list(m16.state_dict()) == keys
    assert "_fused_params" in m16.embedder.unet.__dict__
    # grad on and a parameter requires it: the module, with its graph
    out = run((x, m))
    assert calls == [1] and out.grad_fn is not None
    assert torch.equal(out.detach(), m16.embedder(rgb_to_y(x), m).detach())
    np.testing.assert_allclose(got.numpy(), out.detach().numpy(), atol=F32_ATOL, rtol=0)
    out.sum().backward()
    assert m16.embedder.unet.inc.double_conv[0].weight.grad is not None
    # train mode: the batch's statistics, so the module
    m16.embedder.train()
    with torch.no_grad():
        run((x, m))
    assert calls == [1]
    # without the flag the module serves
    plain = vs_mod._make_run_embedder(model.embedder, model.cfg)
    with torch.no_grad():
        plain((x, m))
    assert calls == [1]


# -- the slice: with_dtype("bfloat16") in both packages ------------------------------

FP, HP, WP = 2, 72, 128           # planar frames
FV, HV, WV = 5, 72, 120           # NHWC video
# u8 frames: within 1 LSB, on at most this share of values (measured: 2.8e-4
# planar, 7.9e-4 video); the tiny card's JND heat times scaling_w 0.2 turns
# a bf16 rounding of the prediction into at most one LSB. Float images: the
# same rounding unrounded (measured 1.1e-4).
U8_SHARE = 5e-3
FLOAT_ATOL = 1e-3


@pytest.fixture(scope="module")
def slice_runs():
    card = tiny_card(img_size=128)
    jm = jax_model_random(card, seed=31)
    pm = port_model(card, jm)
    j16, p16 = jm.with_dtype("bfloat16"), pm.with_dtype("bfloat16")
    assert j16.cfg.fused_embedder and not j16.cfg.s2d_embedder and p16.cfg.fused_embedder
    rng = np.random.default_rng(32)
    planar = rng.integers(0, 256, (FP, HP, WP, 3), np.uint8)
    video = rng.integers(0, 256, (FV, HV, WV, 3), np.uint8)
    imgs = rng.uniform(0, 1, (2, HV, WV, 3)).astype(np.float32)
    msgs = rng.integers(0, 2, (1, NBITS)).astype(np.int32)
    m2 = rng.integers(0, 2, (2, NBITS)).astype(np.int32)
    from videoseal_tpu.kernels.fused_planar import pack_planar as jax_pack
    kw = dict(lowres_attenuation=True, fused_detect=True)
    jp = j16.embed_detect_planar(jax_pack(planar), HP, WP, msgs=jnp.asarray(msgs),
                                 interpret=True, **kw)
    jv = j16.embed(video, msgs=jnp.asarray(msgs), is_video=True)
    ji = j16.embed(imgs, msgs=jnp.asarray(m2))
    from videoseal_tpu.models.videoseal import _make_run_embedder as jax_run
    keys = rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32)
    km = rng.integers(0, 2, (4, NBITS)).astype(np.int32)
    want = {f"embedder{t}": np.asarray(jax_run(m.embedder_spec.module, m.cfg, m.embedder_vars)(
        (jnp.asarray(keys), jnp.asarray(km))), np.float32) for t, m in (("", j16), ("_f32", jm))}
    want.update({"planar": (np.asarray(jp["imgs_w"]), np.asarray(jp["preds"])),
            "video": (np.asarray(jv["imgs_w"]),
                      np.asarray(j16.detect(jv["imgs_w"])["preds"])),
            "image": (np.asarray(ji["imgs_w"]), None)})
    tp = p16.embed_detect_planar(pack_planar(torch.from_numpy(planar)), HP, WP,
                                 msgs=torch.from_numpy(msgs).long(), **kw)
    tv = p16.embed(torch.from_numpy(video), msgs=torch.from_numpy(msgs).long(), is_video=True)
    ti = p16.embed(torch.from_numpy(imgs), msgs=torch.from_numpy(m2).long())
    with torch.no_grad():
        emb = vs_mod._make_run_embedder(p16.embedder, p16.cfg)(
            (torch.from_numpy(keys), torch.from_numpy(km)))
    got = {"planar": (tp["imgs_w"].numpy(), tp["preds"].float().numpy()),
           "video": (tv["imgs_w"].numpy(), p16.detect(tv["imgs_w"])["preds"].float().numpy()),
           "image": (ti["imgs_w"].numpy(), None), "embedder": emb.float().numpy()}
    return want, got


def _u8_diff(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("path", ["planar", "video"])
def test_slice_u8_and_logits(slice_runs, path):
    want, got = slice_runs
    (jw, jl), (tw, tl) = want[path], got[path]
    assert tw.dtype == np.uint8 and tw.shape == jw.shape
    dmax, share = _u8_diff(tw, jw)
    assert dmax <= 1 and share <= U8_SHARE, (dmax, share)
    np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)


def test_slice_float_images(slice_runs):
    want, got = slice_runs
    np.testing.assert_allclose(got["image"][0], want["image"][0], atol=FLOAT_ATOL,
                               rtol=0)


def test_slice_embedder_matches_jax(slice_runs):
    """The chunk forward that both with_dtype("bfloat16") models serve,
    held to JAX's bf16 noise as the UNets above."""
    want, got = slice_runs
    floor = np.abs(want["embedder"] - want["embedder_f32"])
    d = np.abs(got["embedder"] - want["embedder"])
    assert d.mean() <= BF16_MEAN_FACTOR * floor.mean(), (d.mean(), floor.mean())
    assert d.max() <= BF16_MAX_FACTOR * floor.max(), (d.max(), floor.max())
