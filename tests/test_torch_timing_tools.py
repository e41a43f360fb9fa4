"""The port's timing tools, ``evals/unet_bench.py`` and
``evals/stage_bench.py``, against the JAX package's on the tiny card.

* The UNet stages that ``unet_apply_fused`` chains and unet_bench times
  (encoder, inject + bottleneck, decoder), on the tiny card (batch norms,
  ReLU) and videoseal_0.0's layout (rms norms, SiLU): each stage on the
  JAX tool's inputs (x in [-1, 1], a normal embedding) is held within 2e-4
  of its largest value (the JAX package's folded-UNet bound) against the
  same stage written from JAX's ``kernels/unet_fused.py`` helpers as its
  ``unet_bench.py`` writes it, on the same weights.
* Each of stage_bench's stages against the JAX expression on its line, on
  the same inputs (64x96 frames): the folded UNet at 2e-4, the extractor at
  LOGIT_ATOL, the resizes as tests/test_torch_ops.py holds them, K5 (JAX's
  Pallas kernel interpreted) at test_torch_fused_blend.py's DELTA_ATOL, u8
  frames at the NHWC embed tests' rule, the copies exactly.
  The space-to-depth UNet's stages (JAX's ``unet_apply_s2d`` at each of
  the JAX tool's schedules, truncated to the tiny UNet's two levels as JAX
  truncates them) at the folded UNet's bound.
* Both tools' ``main`` with ``--device cpu``: a line naming the device,
  then one line per stage with the JAX tool's names and keys (unet_bench's
  ``--s2d`` and ``--s2d_pieces`` modes after a ``{"schedule"}`` line);
  without ``--device`` they raise on a machine without a card.
"""

import ast

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import LOGIT_ATOL, NBITS, jax_model, port_model, tiny_card, tiny_card_v0

from videoseal_tpu.kernels import fused_blend as jfb
from videoseal_tpu.kernels.unet_fused import _conv as jconv
from videoseal_tpu.kernels.unet_fused import _resnet_block as jresnet
from videoseal_tpu.kernels.unet_fused import _upsample as jupsample
from videoseal_tpu.kernels.unet_fused import unet_apply_fused as jax_unet
from videoseal_tpu.kernels.unet_s2d import unet_apply_s2d as jax_unet_s2d
from videoseal_tpu.models.videoseal import detect_pipeline as jax_detect
from videoseal_tpu.models.videoseal import embed_pipeline as jax_embed
from videoseal_tpu.modules.common import get_activation
from videoseal_tpu.ops.resize import resize_bilinear as jax_resize
from videoseal_tpu_torch.evals import stage_bench, unet_bench
from videoseal_tpu_torch.kernels.unet_fused import bottleneck, decoder, encoder, inject

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, F, H, W, KEYS = 64, 4, 64, 96, 3
UNET_RTOL = 2e-4            # of the stage's largest value
DELTA_ATOL = 2e-7           # tests/test_torch_fused_blend.py
RESIZE_ATOL = 2e-6          # tests/test_torch_ops.py, on [0, 1] values
SW, SI = stage_bench.SCALING_W, stage_bench.SCALING_I
JAX_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def pair():
    card = tiny_card(img_size=S, step=2, chunk=4)
    jm = jax_model(card, seed=51)
    return jm, port_model(card, jm)


def _assert_u8(got, want):
    """The NHWC embed tests' rule: f32 sums in another order may flip a
    rounding at .5."""
    got = got.numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-3, (d > 0).mean()


def _assert_rel(got, want, rtol=UNET_RTOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


# -- unet_bench ---------------------------------------------------------------------

def _jax_stages(jm):
    """unet_bench.py:64-112's encoder, bottleneck and decoder (without its
    _perturb) on jm's weights."""
    u = jm.embedder_spec.module.unet
    p = jm.embedder_vars["params"]["unet"]
    s = jm.embedder_vars.get("batch_stats", {}).get("unet", {})
    norm, act = u.get("normalization", "batch"), get_activation(u.get("activation", "relu"))
    n_levels, hidden = len(u["z_channels_mults"]), jm.embedder_spec.module.hidden_size

    def encoder(x):
        hs = [jresnet(x, p["inc"], s.get("inc", {}), norm, act)]
        for i in range(n_levels - 1):
            d, ds = p[f"downs_{i}"], s.get(f"downs_{i}", {})
            y = jconv(hs[-1], d["down"]["kernel"], d["down"]["bias"], stride=2)
            hs.append(jresnet(y, d["conv"], ds.get("conv", {}), norm, act))
        return hs

    def pre(lat, emb):
        return jnp.concatenate(
            [lat, jnp.broadcast_to(emb[:, None, None, :], lat.shape[:-1] + (hidden,))], -1)

    def bottleneck(lat, emb):
        y = pre(lat, emb)
        for j in range(u.get("num_blocks", 8)):
            y = jresnet(y, p[f"bottleneck_{j}"], s.get(f"bottleneck_{j}", {}), norm, act)
        return y

    def decoder(y, hs):
        hs = list(hs)
        for i in range(n_levels - 1):
            y = jnp.concatenate([y, hs.pop() * 2 ** -0.5], axis=-1)
            up, us = p[f"ups_{i}"], s.get(f"ups_{i}", {})
            y = jupsample(y, up["up"], act)
            y = jresnet(y, up["conv"], us.get("conv", {}), norm, act)
        return jnp.tanh(jconv(y, p["outc"]["kernel"], p["outc"]["bias"], padding=0))

    return encoder, pre, bottleneck, decoder


@pytest.mark.parametrize("layout", ["batch_relu_yuv", "rms_silu_rgb"])
def test_unet_stages_match_jax(pair, layout):
    if layout == "batch_relu_yuv":
        jm, pm = pair
    else:
        card = tiny_card_v0(img_size=S)
        jm = jax_model(card, seed=52)
        pm = port_model(card, jm)
    unet = pm.embedder.unet
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (KEYS, S, S, unet.inc.double_conv[0].in_channels)).astype(np.float32)
    emb = rng.normal(0, 1, (KEYS, unet.msg_processor.hidden_size)).astype(np.float32)
    j_enc, j_pre, j_bot, j_dec = _jax_stages(jm)
    jh = j_enc(jnp.asarray(x))
    lat_j = jh[-1]
    jy = j_bot(lat_j, jnp.asarray(emb))
    jout = j_dec(jy, jh[:-1] + [j_pre(lat_j, jnp.asarray(emb))])
    xt, et = torch.from_numpy(x), torch.from_numpy(emb)
    with torch.no_grad():
        th = encoder(unet, xt)
        assert len(th) == len(jh)
        for a, b in zip(th, jh):
            _assert_rel(a, b)
        # each later stage from the port's own earlier output, as the tool chains them
        lat = th[-1]
        skips = th[:-1] + [inject(unet, lat, et)]
        ty = bottleneck(unet, skips[-1])
        _assert_rel(ty, j_bot(jnp.asarray(lat.numpy()), jnp.asarray(emb)))
        tout = decoder(unet, ty, skips)
        _assert_rel(tout, j_dec(jnp.asarray(ty.numpy()),
                                [jnp.asarray(h.numpy()) for h in skips]))
    # and the whole chain end to end
    _assert_rel(tout, jout)


# -- stage_bench ---------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(3)
    return {"keys": rng.uniform(0, 1, (F // 2, S, S, 1)).astype(np.float32),
            "msgs": rng.integers(0, 2, (1, NBITS)),
            "frames_u8": rng.integers(0, 256, (F, H, W, 3), np.uint8),
            "frames256": rng.uniform(0, 1, (F, S, S, 3)).astype(np.float32),
            "preds1": rng.uniform(-1, 1, (F, S, S, 1)).astype(np.float32),
            "predsf": rng.uniform(-1, 1, (F, H, W)).astype(np.float32),
            "delta0": rng.uniform(-0.01, 0.01, (F, H, W)).astype(np.float32)}


def _jax_blend_u8(fr, delta):
    out = fr.astype(jnp.float32) + 255.0 * delta[..., None]
    return np.asarray(jnp.clip(jnp.round(out), 0.0, 255.0).astype(jnp.uint8))


def _jax_detect(jm, imgs):
    """JAX's detect_pipeline, jitted at XLA's backend level 0 (its eager
    first call takes ~8 s on the CPU)."""
    fn = jax.jit(lambda v, x: jax_detect(jm.extractor_spec.module, jm.cfg, v, x))
    return fn.lower(jm.extractor_vars, imgs).compile(JAX_COMPILE_OPTIONS)(jm.extractor_vars, imgs)


def _jax_stage(jm, name, a):
    """The JAX tool's expression for stage `name` (stage_bench.py:114-212)."""
    cfg, emb = jm.cfg, jm.embedder_spec.module
    evars = jm.embedder_vars
    u = emb.unet
    if name == "unet_fused(keys)" or name.startswith("unet_s2d"):
        key_msgs = jnp.broadcast_to(a["msgs"], (a["keys"].shape[0], cfg.nbits))
        kw = dict(nbits=emb.nbits, hidden_size=emb.hidden_size,
                  z_channels_mults=tuple(u["z_channels_mults"]),
                  activation=u.get("activation", "relu"),
                  normalization=u.get("normalization", "batch"),
                  num_blocks=u.get("num_blocks", 8), last_tanh=u.get("last_tanh", True))
        args = (evars["params"], evars.get("batch_stats", {}), a["keys"], key_msgs)
        if name == "unet_fused(keys)":
            return jax_unet(*args, **kw)
        sch = name.removeprefix("unet_s2d").removesuffix("(keys)")
        return jax_unet_s2d(*args, schedule=None if sch == "inferred" else
                            ast.literal_eval(sch), **kw)
    if name == "extractor(frames@256)":
        return _jax_detect(jm, a["frames256"])
    if name == "resize_down(keys)":
        fr = a["frames_u8"][::cfg.step_size].astype(jnp.float32)
        return jax_resize(fr, cfg.img_size, cfg.img_size, precision=cfg.resize_precision)
    if name == "resize_up(preds)":
        return jax_resize(a["preds1"], H, W, precision=cfg.resize_precision)
    if name == "fused_jnd_delta+blend(fullres)":
        return _jax_blend_u8(a["frames_u8"], jfb.fused_jnd_delta(
            a["frames_u8"], a["predsf"], jnp.float32(SW), interpret=True))
    if name == "full_embed_extract":
        imgs_w, _ = jax_embed(emb, jm.attenuation, cfg, evars, a["frames_u8"], a["msgs"],
                              jnp.float32(SW), jnp.float32(SI), is_video=True,
                              lowres_attenuation=False)
        return np.asarray(imgs_w), _jax_detect(jm, imgs_w)
    if name == "fused_jnd_delta(only)":
        return jfb.fused_jnd_delta(a["frames_u8"], a["predsf"], jnp.float32(SW),
                                   interpret=True)
    if name == "blend_elementwise(only)":
        return _jax_blend_u8(a["frames_u8"], a["delta0"])
    if name == "hbm_copy_u8(frames)":
        return np.asarray(a["frames_u8"])
    if name == "hbm_copy_f32(preds_plane)":
        return a["predsf"] + 1.0
    raise KeyError(name)


def _jax_s2d_schedules() -> list:
    """The schedules of stage_bench.py's unet_s2d loop, read from its source."""
    with open(os.path.join(ROOT, "videoseal_tpu", "evals", "stage_bench.py")) as f:
        return ast.literal_eval(re.search(r"for sched in (\[None,[^\]]*\]):", f.read()).group(1))


S2D_STAGES = [f"unet_s2d{'inferred' if s is None else s}(keys)" for s in _jax_s2d_schedules()]
STAGES = ["unet_fused(keys)", *S2D_STAGES, "extractor(frames@256)", "resize_down(keys)",
          "resize_up(preds)", "fused_jnd_delta+blend(fullres)", "full_embed_extract",
          "fused_jnd_delta(only)", "blend_elementwise(only)", "hbm_copy_u8(frames)",
          "hbm_copy_f32(preds_plane)"]


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_jax(pair, name):
    jm, pm = pair
    a = _inputs()
    fns = dict(stage_bench.stages(pm, {k: torch.from_numpy(v) for k, v in a.items()},
                                  decompose=True))
    assert list(fns) == STAGES
    with torch.no_grad():
        got = fns[name]()
    want = _jax_stage(jm, name, {k: jnp.asarray(v) for k, v in a.items()})
    if name == "unet_fused(keys)" or name.startswith("unet_s2d"):
        _assert_rel(got, want)
    elif name == "extractor(frames@256)":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    elif name.startswith("resize"):
        scale = 255.0 if name == "resize_down(keys)" else 1.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=RESIZE_ATOL * scale)
    elif name == "full_embed_extract":
        _assert_u8(got[0], want[0])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=LOGIT_ATOL,
                                   rtol=0)
    elif name == "fused_jnd_delta(only)":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DELTA_ATOL, rtol=0)
    elif got.dtype == torch.uint8 and name != "hbm_copy_u8(frames)":
        _assert_u8(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the entry points ------------------------------------------------------------------

def _jax_stage_names() -> list:
    """The names of stage_bench.py's report() calls, in order, the unet_s2d
    ones (f-strings in its loop) after unet_fused(keys)."""
    with open(os.path.join(ROOT, "videoseal_tpu", "evals", "stage_bench.py")) as f:
        names = re.findall(r'report\("([^"]+)"', f.read())
    return names[:1] + S2D_STAGES + names[1:]


@pytest.fixture(scope="module")
def card_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("card") / "tiny.json")
    with open(path, "w") as f:
        json.dump(tiny_card(img_size=S, step=2, chunk=4), f)
    return path


def _lines(out: str) -> list:
    return [json.loads(ln) for ln in out.strip().splitlines()]


def test_mains_print_jax_names_and_keys(card_file, capsys):
    rec = unet_bench.main(["--device", "cpu", "--card", card_file, "--keys", "2", "--k", "1",
                           "--dtype", "float32"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0] == {"device": "cpu"} and rec["device"] == "cpu"
    assert [ln["stage"] for ln in lines[1:]] == ["encoder", "bottleneck", "decoder"]
    assert all(set(ln) == {"stage", "ms", "per_key_us"} and ln["ms"] > 0 for ln in lines[1:])
    assert rec["stages"] == lines[1:]
    for mode, want in (("--s2d", ["s2d_encoder", "s2d_bottleneck", "s2d_decoder"]),
                       ("--s2d_pieces", ["s2d_up0", "s2d_outc"])):
        rec = unet_bench.main(["--device", "cpu", "--card", card_file, "--keys", "2", "--k", "1",
                               "--dtype", "float32", mode, "1"])
        lines = _lines(capsys.readouterr().out)
        assert lines[0] == {"device": "cpu"} and lines[1] == {"schedule": [4, 4]}
        assert [ln["stage"] for ln in lines[2:]] == want and rec["stages"] == lines[2:]
        keys = {"stage", "ms", "per_key_us"} if mode == "--s2d" else {"stage", "ms"}
        assert all(set(ln) == keys and ln["ms"] > 0 for ln in lines[2:])

    rec = stage_bench.main(["--device", "cpu", "--card", card_file, "--frames", str(F),
                            "--height", str(H), "--width", str(W), "--k", "1", "--decompose"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0] == {"device": "cpu"} and rec["stages"] == lines[1:]
    names = [ln["stage"] for ln in lines[1:]]
    assert names == _jax_stage_names() == STAGES
    assert all(set(ln) == {"stage", "ms", "per_frame_us"} for ln in lines[1:])
    stage_bench.main(["--device", "cpu", "--card", card_file, "--frames", "2",
                      "--height", str(H), "--width", str(W), "--k", "1"])
    names = [ln["stage"] for ln in _lines(capsys.readouterr().out)[1:]]
    assert names == STAGES[:10]


def test_stage_bench_error_line_only_for_a_schedule(card_file, capsys, monkeypatch):
    """A schedule the UNet cannot take (ValueError) prints JAX's
    {"stage", "error"} line; any other fault of an s2d stage (a CUDA or
    cuDNN RuntimeError) propagates."""
    def fails(ex):
        def fn():
            raise ex
        return fn
    monkeypatch.setattr(stage_bench, "stages", lambda model, inputs, decompose: [
        ("unet_s2d(4,)(keys)", fails(ValueError("schedule (4,) has 1 levels")))])
    args = ["--device", "cpu", "--card", card_file, "--frames", "2",
            "--height", str(H), "--width", str(W), "--k", "1"]
    rec = stage_bench.main(args)
    assert rec["stages"] == [{"stage": "unet_s2d(4,)", "error": "schedule (4,) has 1 levels"}]
    assert _lines(capsys.readouterr().out)[1:] == rec["stages"]
    monkeypatch.setattr(stage_bench, "stages", lambda model, inputs, decompose: [
        ("unet_s2d(4, 2, 1, 1)(keys)", fails(RuntimeError("CUDA out of memory")))])
    with pytest.raises(RuntimeError, match="out of memory"):
        stage_bench.main(args)


@pytest.mark.parametrize("tool", [unet_bench, stage_bench], ids=lambda t: t.__name__)
def test_default_device_is_the_card(tool, card_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--card", card_file])
