"""The port's space-to-depth UNet (``kernels/unet_s2d.py``) against the JAX
package's ``unet_apply_s2d`` and against the port's folded forward and its
module; ``pack_conv``, ``pack_up_conv``, the composed upsample and
``s2d_schedule`` against JAX's; the lane-packed conv (``kernels/lane_pack.py``)
against JAX's and a plain conv, and ``unet_apply_fused(lane_pack=True)``;
the rule by which ``with_dtype`` sets ``s2d_embedder``, the route and the
cache of the cell-space weights. The slices are in
tests/test_torch_unet_s2d_slice.py.

Tolerances: float32 within 3e-4 absolute and 1e-4 relative, the JAX
package's own bound (tests/test_unet_s2d.py). In bf16 the port is held to
the JAX package's own bf16 noise on the same input, as
tests/test_torch_unet_fused.py states that rule: its mean |difference| from
JAX's bf16 within 1.5 times, its largest within 2 times, the mean and the
largest distance of JAX's bf16 s2d forward from its float32 one."""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from torch_port import NBITS, jax_random_vars, tiny_card

from videoseal_tpu.kernels import lane_pack as jax_lp
from videoseal_tpu.kernels.unet_s2d import pack_conv as jax_pack_conv
from videoseal_tpu.kernels.unet_s2d import s2d_schedule as jax_schedule
from videoseal_tpu.kernels.unet_s2d import unet_apply_s2d as jax_s2d
from videoseal_tpu.models.embedder import build_embedder as jax_build_embedder
from videoseal_tpu.models.extractor import build_extractor as jax_build_extractor
from videoseal_tpu.models.videoseal import PipelineConfig as JaxConfig
from videoseal_tpu.models.videoseal import VideoSeal as JaxVideoSeal
from videoseal_tpu_torch import VideoSeal
from videoseal_tpu_torch.kernels import lane_pack
from videoseal_tpu_torch.cards import CARDS
from videoseal_tpu_torch.kernels import unet_s2d as us
from videoseal_tpu_torch.kernels.unet_fused import unet_apply_fused
from videoseal_tpu_torch.models import videoseal as vs_mod
from videoseal_tpu_torch.models.embedder import build_embedder
from videoseal_tpu_torch.utils.convert import embedder_from_jax

torch.set_num_threads(1)

ATOL, RTOL = 3e-4, 1e-4
BF16_MEAN_FACTOR, BF16_MAX_FACTOR = 1.5, 2.0
NB, S = 8, 64
JAX_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}
# JAX's five cases (tests/test_unet_s2d.py): (norm, act, schedule)
CASES = [("batch", "relu", None), ("batch", "relu", (2, 2)), ("batch", "relu", (4, 1)),
         ("batch", "relu", (1, 1)), ("rms", "silu", (2, 2))]


def _cfg(norm: str, act: str) -> dict:
    return {"msg_processor": {"msg_processor_type": "binary+concat"},
            "unet": {"in_channels": 1, "out_channels": 1, "z_channels": 4, "num_blocks": 2,
                     "activation": act, "normalization": norm, "z_channels_mults": [1, 2],
                     "last_tanh": True}}


def _jax_run(fn, v, x, m, dt):
    vv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), v)
    args = (vv["params"], vv.get("batch_stats", {}), jnp.asarray(x, dt), jnp.asarray(m))
    return np.asarray(jax.jit(fn).lower(*args).compile(JAX_COMPILE_OPTIONS)(*args), np.float32)


@functools.lru_cache(maxsize=None)
def _unet(norm: str, act: str):
    """A tiny UNet (z=4, mults (1, 2), two blocks, 64 px) in both packages
    with the same random weights (BatchNorm statistics and rms gains drawn
    with numpy), its inputs, and JAX's variables."""
    cfg = _cfg(norm, act)
    js = jax_build_embedder("unet_x_yuv", cfg, NB, 2)
    v = jax_random_vars(js.module, jnp.zeros((1, S, S, 1)), jnp.zeros((1, NB), jnp.int32),
                        seed=len(norm))
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, S, S, 1)).astype(np.float32)
    m = rng.integers(0, 2, (2, NB))
    ts = build_embedder("unet_x_yuv", cfg, NB, 2)
    ts.module.load_state_dict(embedder_from_jax(v))
    kw = dict(nbits=NB, hidden_size=2 * NB, z_channels_mults=(1, 2), activation=act,
              normalization=norm, num_blocks=2)
    return ts.module.eval(), torch.from_numpy(x), torch.from_numpy(m), v, kw


@functools.lru_cache(maxsize=None)
def _jax_s2d(norm: str, act: str, sch, dt: str) -> np.ndarray:
    """JAX's s2d forward of `_unet(norm, act)` at `sch` in `dt` (params cast
    first, as JAX's with_dtype casts them)."""
    _, x, m, v, kw = _unet(norm, act)
    return _jax_run(lambda p, s, xx, mm: jax_s2d(p, s, xx, mm, schedule=sch, **kw), v,
                    x.numpy(), m.numpy(), dt)


def _case_ids(c):
    return f"{c[0]}-{c[1]}-{'inferred' if c[2] is None else 'x'.join(map(str, c[2]))}"


def _s2d(emb, x, m, dtype, sch):
    mod = copy.deepcopy(emb).to(dtype)
    with torch.no_grad():
        return us.unet_apply_s2d(mod.unet, x.to(dtype), m, sch).float().numpy()


@pytest.mark.parametrize("case", CASES, ids=_case_ids)
def test_s2d_matches_jax_f32(case):
    norm, act, sch = case
    emb, x, m, _, _ = _unet(norm, act)
    got, want = _s2d(emb, x, m, torch.float32, sch), _jax_s2d(norm, act, sch, "float32")
    assert got.shape == want.shape == tuple(x.shape)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=_case_ids)
def test_s2d_matches_jax_bf16(case):
    norm, act, sch = case
    emb, x, m, _, _ = _unet(norm, act)
    got = _s2d(emb, x, m, torch.bfloat16, sch)
    want, want32 = _jax_s2d(norm, act, sch, "bfloat16"), _jax_s2d(norm, act, sch, "float32")
    floor, d = np.abs(want - want32), np.abs(got - want)
    assert d.mean() <= BF16_MEAN_FACTOR * floor.mean(), (d.mean(), floor.mean())
    assert d.max() <= BF16_MAX_FACTOR * floor.max(), (d.max(), floor.max())


@pytest.mark.parametrize("case", CASES, ids=_case_ids)
def test_s2d_matches_fused_and_module(case):
    """The same function as the port's folded forward and its module, on
    other operand layouts (the JAX package's parity tests, in the port)."""
    norm, act, sch = case
    emb, x, m, _, _ = _unet(norm, act)
    got = _s2d(emb, x, m, torch.float32, sch)
    with torch.no_grad():
        fused = unet_apply_fused(emb.unet, x, m).numpy()
        module = emb(x, m).numpy()
    np.testing.assert_allclose(got, fused, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, module, atol=ATOL, rtol=RTOL)


# -- the packers and the cell-space convs --------------------------------------------

# JAX's cases (tests/test_unet_s2d.py::TestConvS2d): (s_in, s_out, stride, k)
PACKS = [(2, 2, 1, 3), (4, 4, 1, 3), (2, 2, 1, 1), (4, 4, 1, 1), (4, 2, 2, 3), (2, 1, 2, 3),
         (2, 2, 2, 3), (1, 2, 1, 3), (1, 4, 1, 3)]


@pytest.mark.parametrize("s_in,s_out,stride,k", PACKS)
def test_pack_conv_matches_jax(s_in, s_out, stride, k):
    """pack_conv's weights are JAX's after the layout change (OIHW here,
    HWIO there), exactly; conv_s2d on s2d(s_in) input is the direct conv."""
    rng = np.random.default_rng(0)
    ci, co, h = 3, 5, 32
    w = rng.normal(size=(k, k, ci, co)).astype(np.float32)
    wc, cs, cd = us.pack_conv(torch.from_numpy(w).permute(3, 2, 0, 1), stride, s_in, s_out)
    jwc, jcs, jcd = jax_pack_conv(jnp.asarray(w), stride, s_in, s_out)
    np.testing.assert_array_equal(wc.permute(2, 3, 1, 0).numpy(), np.asarray(jwc))
    assert (cs, cd) == (jcs, jcd)
    x = torch.from_numpy(rng.normal(size=(2, h, h, ci)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32))
    packed = (wc.contiguous(memory_format=torch.channels_last), b.repeat(s_out * s_out), cs, cd)
    got = us.d2s(us.conv_s2d(us.s2d(x, s_in), packed, conv_stride=stride, s_in=s_in,
                             s_out=s_out), s_out)
    ref = F.conv2d(x.permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1), b,
                   stride=stride, padding=(k - 1) // 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4, rtol=1e-4)


def test_pack_conv_prepadded():
    """pad=0 on a reflect-padded input (JAX's test_prepadded)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 16, 16, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(6, 4, 3, 3)).astype(np.float32))
    xp = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    xp = torch.cat([xp[:, :, 1:2], xp, xp[:, :, -2:-1]], dim=2)
    wc, cs, cd = us.pack_conv(w, 1, 1, 2, pad=0)
    got = us.d2s(us.conv_s2d(xp, (wc, None, cs, cd), s_in=1, s_out=2, pad=0), 2)
    ref = F.conv2d(xp.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4, rtol=1e-4)


def test_pack_up_conv_matches_jax():
    from videoseal_tpu.kernels.unet_s2d import pack_up_conv as jax_pack_up
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 3, 6, 4)).astype(np.float32)
    for s in (1, 2):
        got = us.pack_up_conv(torch.from_numpy(w).permute(3, 2, 0, 1), s)
        want = np.asarray(jax_pack_up(jnp.asarray(w), s))
        np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want, atol=1e-6, rtol=0)


# JAX's cases (TestComposedUpsample): (s_in, s_out, h, w)
UPS = [(1, 1, 8, 8), (1, 2, 8, 12), (2, 2, 8, 8), (2, 1, 6, 10), (2, 4, 8, 8)]


@pytest.mark.parametrize("s_in,s_out,h,w", UPS)
def test_composed_upsample_matches_plain_and_jax(s_in, s_out, h, w):
    """The composed Upsample block against the plain-space one and JAX's
    composed block on the same weights."""
    from videoseal_tpu.kernels.unet_s2d import _upsample_s2d_composed as jax_up
    from videoseal_tpu_torch.modules.common import Upsample
    rng = np.random.default_rng(3)
    ci, co = 6, 4
    up = Upsample("bilinear", ci, co, 2, "relu").eval()
    kern = rng.normal(size=(3, 3, ci, co)).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    lnw = rng.uniform(0.5, 2, (co,)).astype(np.float32)
    lnb = rng.normal(size=(co,)).astype(np.float32)
    with torch.no_grad():
        up.upsample_block[3].weight.copy_(torch.from_numpy(lnw))
        up.upsample_block[3].bias.copy_(torch.from_numpy(lnb))
    fp = {up.upsample_block[2]: (torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous(),
                                 torch.from_numpy(bias))}
    act = torch.nn.ReLU()
    x = rng.normal(size=(2, h, w, s_in * s_in * ci)).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = us._upsample_s2d_composed(xt, up, fp, {}, act, s_in, s_out).numpy()
        plain = us._upsample_s2d(xt, up, fp, {}, act, s_in, s_out).numpy()
    p = {"conv": {"kernel": jnp.asarray(kern), "bias": jnp.asarray(bias)},
         "norm": {"weight": jnp.asarray(lnw), "bias": jnp.asarray(lnb)}}
    want = np.asarray(jax_up(jnp.asarray(x), p, lambda v: jnp.maximum(v, 0), s_in, s_out))
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# -- the schedule ----------------------------------------------------------------------

SCHEDULES = {"videoseal_1.0": (2, 2, 1, 1), "videoseal_0.0": (2, 2, 1, 1),
             "pixelseal": (2, 1, 1, 1), "chunkyseal": (1, 1, 1, 1)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    card = CARDS[name]
    u = card["embedder"]["params"]["unet"]
    size = card["args"]["img_size_proc"]
    args = (size, u["z_channels"], tuple(u["z_channels_mults"]))
    assert us.s2d_schedule(*args) == jax_schedule(*args) == SCHEDULES[name]
    unet = build_embedder(card["embedder"]["model"], dict(card["embedder"]["params"],
                                                          unet=dict(u, num_blocks=1)),
                          card["args"]["nbits"], 1.0).module.unet
    assert us.schedule_for(unet, size) == SCHEDULES[name]
    # JAX's sanitising, and a longer schedule cut to the levels as JAX reads it
    assert us.schedule_for(unet, size, (8, 1, 1, 1, 4)) == (2, 1, 1, 1)
    with pytest.raises(ValueError, match="levels"):
        us.schedule_for(unet, size, (1, 1))


# -- lane_pack --------------------------------------------------------------------------

@pytest.mark.parametrize("prepadded", [False, True])
def test_lane_pack_matches_jax_and_conv(prepadded):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 66, 66, 5) if prepadded else (2, 64, 64, 5)).astype(np.float32)
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got = lane_pack.conv3x3_lane_packed(torch.from_numpy(x), wt, torch.from_numpy(b),
                                        prepadded=prepadded)
    want = np.asarray(jax_lp.conv3x3_lane_packed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                                 prepadded=prepadded))
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), wt, torch.from_numpy(b),
                   padding=0 if prepadded else 1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(np.asarray(jax_lp.pack_weight(jnp.asarray(w))),
                                  lane_pack.pack_weight(wt).permute(2, 3, 1, 0).numpy())
    for xs, ws in (((2, 64, 64, 5), (7, 5, 3, 3)), ((2, 62, 64, 5), (7, 5, 3, 3)),
                   ((2, 64, 64, 5), (40, 5, 3, 3)), ((2, 32, 64, 5), (7, 5, 3, 3))):
        assert lane_pack.supports_lane_pack(xs, ws) == jax_lp.supports_lane_pack(
            xs, (ws[2], ws[3], ws[1], ws[0]))


@pytest.mark.parametrize("norm", ["batch", "rms"])
def test_unet_fused_lane_pack(norm):
    """unet_apply_fused(lane_pack=True) against lane_pack=False on a UNet
    whose 64-px levels lane-pack."""
    emb, x, m, _, _ = _unet(norm, "relu" if norm == "batch" else "silu")
    with torch.no_grad():
        a = unet_apply_fused(emb.unet, x, m, lane_pack=True).numpy()
        b = unet_apply_fused(emb.unet, x, m).numpy()
    np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)


# -- the route: with_dtype's rule, run_embedder, the cache ---------------------------------

def _rule_cards() -> dict:
    """Cards whose UNet takes the folded route or not, at processing sizes
    that are multiples of 8 or not."""
    base = tiny_card(img_size=64)
    group = copy.deepcopy(base)
    group["embedder"]["params"]["unet"].update(normalization="group", z_channels=8)
    p2 = copy.deepcopy(base)
    p2["embedder"]["params"]["unet"]["conv_layer"] = "conv2p1d"
    return {"tiny64": base, "tiny60": tiny_card(img_size=60), "tiny72": tiny_card(img_size=72),
            "group": group, "conv2p1d": p2}


@pytest.mark.parametrize("name", list(_rule_cards()))
def test_with_dtype_s2d_rule_as_jax(name):
    """s2d_embedder_rule gives JAX's with_dtype answer: on a card-resident
    model JAX's answer on its accelerator (fused_blend on), on the CPU
    JAX's answer there (False); the port's with_dtype on the CPU sets
    False."""
    card = _rule_cards()[name]
    a, e = card["args"], card["embedder"]
    s = a["img_size_proc"]
    jemb = jax_build_embedder(e["model"], e["params"], a["nbits"], a["hidden_size_multiplier"])
    jext = jax_build_extractor(card["extractor"]["model"], card["extractor"]["params"], s,
                               a["nbits"])
    jm = JaxVideoSeal(jemb, jext, {}, {}, None, JaxConfig(img_size=s, nbits=a["nbits"]))
    on_card = jm.with_dtype("bfloat16", fused_blend=True).cfg
    on_cpu = jm.with_dtype("bfloat16", fused_blend=False).cfg
    assert not on_cpu.s2d_embedder
    assert vs_mod.s2d_embedder_rule(on_card.fused_embedder, s, "cuda") == on_card.s2d_embedder
    assert vs_mod.s2d_embedder_rule(on_cpu.fused_embedder, s, "cpu") == on_cpu.s2d_embedder
    pm = VideoSeal.from_card(card, device="cpu")
    for dt in ("bfloat16", "float32"):
        cfg = pm.with_dtype(dt).cfg
        assert cfg.fused_embedder == on_card.fused_embedder and not cfg.s2d_embedder
    assert on_card.s2d_embedder == (name in ("tiny64", "tiny72"))


def test_run_embedder_routes_s2d(monkeypatch):
    """With s2d_embedder set, the chunk forward serves unet_apply_s2d in eval
    mode without autograd, the module otherwise; its output is the folded
    forward's."""
    model = VideoSeal.from_card(tiny_card(img_size=64), device="cpu").with_dtype("float32")
    cfg = dataclasses.replace(model.cfg, s2d_embedder=True)
    calls = []
    real = vs_mod.unet_apply_s2d
    monkeypatch.setattr(vs_mod, "unet_apply_s2d", lambda *a: calls.append(1) or real(*a))
    run = vs_mod._make_run_embedder(model.embedder, cfg)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    m = torch.from_numpy(rng.integers(0, 2, (2, NBITS)))
    with torch.no_grad():
        got = run((x, m))
        fused = vs_mod._make_run_embedder(model.embedder, model.cfg)((x, m))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=ATOL, rtol=RTOL)
    out = run((x, m))                       # autograd: the module
    assert calls == [1] and out.grad_fn is not None
    model.embedder.train()
    with torch.no_grad():
        run((x, m))
    assert calls == [1]


def test_s2d_params_cached():
    """The cell-space weights are packed once and kept beside the fold; an
    in-place change of a BatchNorm statistic, or a cast, packs anew."""
    emb, x, m, _, _ = _unet("batch", "relu")
    emb = copy.deepcopy(emb)
    unet = emb.unet
    with torch.no_grad():
        a = us.unet_apply_s2d(unet, x, m)
        cp = us.s2d_params(unet)[1]
        n = len(cp)
        assert n > 0 and us.s2d_params(unet)[1] is cp
        us.unet_apply_s2d(unet, x, m)
        assert us.s2d_params(unet)[1] is cp and len(cp) == n
        unet.inc.double_conv[1].running_var.mul_(2.0)
        assert us.s2d_params(unet)[1] is not cp
        b = us.unet_apply_s2d(unet, x, m)
        assert not np.allclose(a.numpy(), b.numpy())
        np.testing.assert_allclose(b.numpy(), emb(x, m).numpy(), atol=ATOL, rtol=RTOL)
        unet.to(torch.bfloat16)
        us.unet_apply_s2d(unet, x.to(torch.bfloat16), m)
        conv = unet.inc.double_conv[0]
        assert all(v[0].dtype == torch.bfloat16 for k, v in us.s2d_params(unet)[1].items()
                   if k[0] is conv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_strip_convs_tf32(dtype, monkeypatch):
    """A bf16 forward's border-strip convs (float32 weights) run with
    cuDNN's TF32 on whatever the global flag; a float32 forward's keep the
    flag; the flag is restored after the call."""
    emb, x, m, _, _ = _unet("batch", "relu")
    seen, conv2d = [], F.conv2d

    def spy(inp, weight, *a, **k):
        seen.append((weight.dtype, torch.backends.cudnn.allow_tf32))
        return conv2d(inp, weight, *a, **k)
    monkeypatch.setattr(us.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _s2d(emb, x, m, dtype, (2, 2))
    strips = [tf for wd, tf in seen if wd == torch.float32]
    others = [tf for wd, tf in seen if wd != torch.float32]
    assert strips and not any(others)
    assert all(strips) if dtype == torch.bfloat16 else not any(strips)
    assert torch.backends.cudnn.allow_tf32 is False
