"""The port's temporal layers against the JAX package on the CPU: the
convolutions over frames (TemporalConv, Conv2p1dOp, Conv3dOp) forward and
backward, temporal attention (its block, the ViT and the ConvNeXt that carry
it), the temporal ConvNeXt on both routes, the padded last chunk of a model
that mixes frames, and the 2D -> 2+1D inflation script. Tiny widths; the
JAX oracles take random variables through ``jax.eval_shape`` (no init is
compiled) and run jitted."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port import LOGIT_ATOL, NBITS, jax_model_random, jax_random_vars, tiny_card, to_np

from videoseal_tpu.modules import common as jcommon
from videoseal_tpu.modules import convnext as jconvnext
from videoseal_tpu.modules import vit as jvit
from videoseal_tpu_torch.modules import common, convnext, vit

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 convolutions and matmuls on both sides: the sums' order only
F32_ATOL = 2e-5
# gradients against jax.grad, relative to each tensor's largest
GRAD_RTOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _c3d(k) -> torch.Tensor:
    """flax 3D kernel (kt, kh, kw, I, O) -> torch (O, I, kt, kh, kw)."""
    return _t(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def _c2d(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _frames(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _close_rel(got, want, rtol):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol * max(float(np.abs(want).max()), 1e-12))


# -- the convolutions over frames --------------------------------------------------

def _conv_pair(kind: str, cin: int, cout: int, k: int, stride: int = 1):
    """(linen module, its variables, the port module holding them)."""
    x = jnp.zeros((5, 8, 8, cin))
    if kind == "temporal":
        lin = jconvnext.TemporalConv(cout, k)
        v = jax_random_vars(lin, x, seed=k)
        port = common.TemporalConv(cin, cout, k)
        port.load_state_dict({"weight": _c3d(v["params"]["conv"]["kernel"])})
        return lin, v, port
    lin = {"conv2p1d": jcommon.Conv2p1dOp, "conv3d": jcommon.Conv3dOp}[kind](cout, k, stride)
    v = jax_random_vars(lin, x, seed=k + 1)
    port = common.get_conv_op(kind)(cin, cout, k, stride=stride)
    p = v["params"]
    if kind == "conv3d":
        sd = {"conv.weight": _c3d(p["conv"]["kernel"]), "conv.bias": _t(p["conv"]["bias"])}
    else:
        sd = {"conv.weight": _c2d(p["spatial"]["conv"]["kernel"]),
              "conv.bias": _t(p["spatial"]["conv"]["bias"])}
        if k != 1:
            sd["temp_conv.weight"] = _c3d(p["temporal"]["kernel"])
    port.load_state_dict(sd)
    return lin, v, port


@pytest.mark.parametrize("kind,k,stride", [("temporal", 3, 1), ("temporal", 5, 1),
                                           ("conv2p1d", 3, 1), ("conv2p1d", 3, 2),
                                           ("conv2p1d", 1, 1), ("conv3d", 3, 1),
                                           ("conv3d", 3, 2)])
def test_frame_convs_match_linen(kind, k, stride):
    """TemporalConv, Conv2p1dOp and Conv3dOp mix the 5 frames of the batch as
    the linen modules do (zero padding at the clip's ends)."""
    lin, v, port = _conv_pair(kind, 6, 8, k, stride)
    x = _frames((5, 8, 8, 6), 3)
    want = np.asarray(jax.jit(lin.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL)
    assert common.mixes_frames(port) == (k != 1 or kind == "conv3d")


@pytest.mark.parametrize("kind", ["temporal", "conv2p1d"])
def test_frame_conv_grads_match_jax(kind):
    """d(sum(y * w)) by the input and every weight against jax.grad."""
    lin, v, port = _conv_pair(kind, 4, 6, 3)
    x = _frames((5, 8, 8, 4), 4)
    w = _frames((5, 8, 8, 6), 5)

    def loss(params, xx):
        return jnp.sum(lin.apply({"params": params}, xx) * w)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    (port(xt).permute(0, 2, 3, 1) * _t(w)).sum().backward()
    _close_rel(xt.grad.permute(0, 2, 3, 1), gx, GRAD_RTOL)
    if kind == "temporal":
        _close_rel(port.weight.grad, _c3d(gp["conv"]["kernel"]), GRAD_RTOL)
        return
    _close_rel(port.conv.weight.grad, _c2d(gp["spatial"]["conv"]["kernel"]), GRAD_RTOL)
    _close_rel(port.conv.bias.grad, gp["spatial"]["conv"]["bias"], GRAD_RTOL)
    _close_rel(port.temp_conv.weight.grad, _c3d(gp["temporal"]["kernel"]), GRAD_RTOL)


# -- temporal attention ----------------------------------------------------------

def _vit_sd(tree: dict, prefix: str = "") -> dict:
    """A linen ViT subtree's params as the port's state dict (Dense kernels
    transposed, LayerNorm scale as weight)."""
    sd = {}
    for k, val in tree.items():
        name = f"{prefix}{k}"
        if isinstance(val, dict):
            sd.update(_vit_sd(val, f"{name}."))
        elif k == "kernel":
            sd[f"{prefix}weight"] = _t(np.asarray(val).T)
        elif k == "scale":
            sd[f"{prefix}weight"] = _t(val)
        else:
            sd[name] = _t(val)
    return sd


@pytest.mark.parametrize("rel_pos,video_len", [(False, 4), (True, 4), (True, 8)])
def test_temporal_block_matches_linen(rel_pos, video_len):
    """TemporalBlock over 4 frames: attention across frames at each of the
    3x5 locations; with rel_pos of a table made for video_len frames (8:
    resampled to 7 rows by get_rel_pos)."""
    x = _frames((4, 3, 5, 16), 6)
    lin = jvit.TemporalBlock(16, num_heads=2, use_rel_pos=rel_pos, video_len=video_len)
    v = jax_random_vars(lin, jnp.asarray(x), seed=7)
    want = np.asarray(jax.jit(lin.apply)(v, jnp.asarray(x)))
    port = vit.TemporalBlock(16, 2, use_rel_pos=rel_pos, video_len=video_len)
    port.load_state_dict(_vit_sd(v["params"]))
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(to_np(got), want, atol=F32_ATOL)
    assert common.mixes_frames(port)


def test_temporal_vit_matches_linen():
    """ImageEncoderViT(temporal_attention=True): a TemporalBlock after every
    block and pos_embed_temporal on the first F frames, through the weight
    bridge (``encoder.temp_block_{i}`` <-> ``image_encoder.temp_blocks.{i}``)."""
    from videoseal_tpu.models.extractor import build_extractor as jbuild
    from videoseal_tpu_torch.models.extractor import build_extractor
    from videoseal_tpu_torch.utils.convert import from_jax_variables, to_jax_variables
    cfg = {"encoder": {"embed_dim": 16, "out_chans": 16, "depth": 2, "num_heads": 2,
                       "patch_size": 16, "global_attn_indexes": [1], "window_size": 1,
                       "mlp_ratio": 2, "qkv_bias": True, "use_rel_pos": True,
                       "temporal_attention": True, "max_temporal_length": 8},
           "pixel_decoder": {"pixelwise": False, "upscale_stages": [1], "embed_dim": 16}}
    x = np.random.default_rng(8).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    jspec = jbuild("sam_small", copy.deepcopy(cfg), 32, NBITS)
    v = jax_random_vars(jspec.module, jnp.asarray(x), seed=9)
    want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x)))
    spec = build_extractor("sam_small", copy.deepcopy(cfg), 32, NBITS)
    _, sd = from_jax_variables({"params": {"unet": {}}}, v)
    spec.module.load_state_dict(sd)
    assert tuple(spec.module.image_encoder.pos_embed_temporal.shape) == (8, 1, 1, 16)
    with torch.no_grad():
        got = spec.module(_t(x))
    np.testing.assert_allclose(to_np(got), want, atol=1e-4)
    _, back = to_jax_variables({}, spec.module.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat) == len(jax.tree_util.tree_leaves(v))
    for path, a in flat:
        ref = v
        for k in path:
            ref = ref[k.key]
        np.testing.assert_array_equal(a, np.asarray(ref))


# -- the temporal ConvNeXt ----------------------------------------------------------

TEMPORAL_ENC = {"depths": [1, 1, 1, 1], "dims": [8, 16, 32, 64], "temporal_convs": True}


def _convnext_pair(enc: dict, pixelwise: bool = False, seed: int = 10):
    from videoseal_tpu.models.extractor import build_extractor as jbuild
    from videoseal_tpu_torch.models.extractor import build_extractor
    from videoseal_tpu_torch.utils.convert import from_jax_variables
    dims = enc["dims"]
    cfg = {"encoder": dict(enc), "pixel_decoder": {
        "pixelwise": pixelwise, "upscale_stages": [4, 2, 2] if pixelwise else [1],
        "embed_dim": dims[-1], "sigmoid_output": False}}
    jspec = jbuild("convnext_tiny", copy.deepcopy(cfg), 64, NBITS)
    v = jax_random_vars(jspec.module, jnp.zeros((4, 64, 64, 3)), seed=seed)
    spec = build_extractor("convnext_tiny", copy.deepcopy(cfg), 64, NBITS)
    _, sd = from_jax_variables({"params": {"unet": {}}}, v)
    spec.module.load_state_dict(sd)
    return jspec, v, spec.module


def test_temporal_convnext_both_routes(monkeypatch):
    """convnext_tiny_temporal's layout: the 3x1x1 conv over frames after the
    downsample conv of stages 1-3, held against the linen module (not the
    JAX fused route, which drops it) on the kernel route (every block a K2
    call, rounding to bf16 inside as the kernel does) and on the module-math
    route (f32)."""
    from videoseal_tpu_torch.kernels import convnext_fused
    jspec, v, ext = _convnext_pair(TEMPORAL_ENC)
    assert isinstance(ext.convnext.downsample_layers[1][1], common.Conv2p1dOp)
    x = np.random.default_rng(11).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x)))
    calls = []
    real = convnext_fused.convnext_block_fused
    monkeypatch.setattr(convnext_fused, "convnext_block_fused",
                        lambda xx, p: calls.append(xx.shape) or real(xx, p))
    with torch.no_grad():
        kern = ext(_t(x))
    assert len(calls) == 4   # one K2 call a block, as the 2D model's
    np.testing.assert_allclose(to_np(kern), want, atol=LOGIT_ATOL)
    xt = _t(x).requires_grad_(True)
    plain = ext(xt)
    np.testing.assert_allclose(to_np(plain), want, atol=1e-4)
    # the frames are mixed: frame 0's logits change with frame 3
    x2 = x.copy()
    x2[3] = 1 - x2[3]
    with torch.no_grad():
        assert float((ext(_t(x2))[0] - kern[0]).abs().max()) > 1e-3


def test_temporal_attention_convnext_takes_module_math(monkeypatch):
    """ConvNeXt blocks with temp_block (heads = dim // 48, rel_pos over 32
    frames resampled to 4) match the linen module; K2 fuses the residual, so
    they take their module math on the kernel route too: no K2 call."""
    from videoseal_tpu_torch.kernels import convnext_fused
    enc = {"depths": [1, 1, 1, 1], "dims": [48, 96, 144, 192], "temporal_attention": True}
    jspec, v, ext = _convnext_pair(enc, seed=12)
    assert ext.convnext.stages[2][0].temp_block.attn.num_heads == 3
    x = np.random.default_rng(13).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jspec.module.apply)(v, jnp.asarray(x)))
    monkeypatch.setattr(convnext_fused, "convnext_block_fused",
                        lambda *a: pytest.fail("a temp_block block reached K2"))
    with torch.no_grad():
        got = ext(_t(x))
    np.testing.assert_allclose(to_np(got), want, atol=2e-4)


def test_temporal_conv_grad_through_extractor():
    """The temporal extractor's input gradient (module math) against jax.grad."""
    jspec, v, ext = _convnext_pair(TEMPORAL_ENC, seed=14)
    x = np.random.default_rng(15).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    w = np.random.default_rng(16).normal(size=(4, 1 + NBITS)).astype(np.float32)
    gx = jax.jit(jax.grad(lambda xx: jnp.sum(jspec.module.apply(v, xx) * w)))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (ext(xt) * _t(w)).sum().backward()
    _close_rel(xt.grad, gx, GRAD_RTOL)


# -- the padded last chunk -----------------------------------------------------------

def _temporal_card(chunk: int = 4, step: int = 2) -> dict:
    card = tiny_card(img_size=64, step=step, chunk=chunk)
    card["embedder"]["params"]["unet"]["conv_layer"] = "conv2p1d"
    card["extractor"]["params"]["encoder"]["temporal_convs"] = True
    return card


@pytest.fixture(scope="module")
def temporal_models():
    from torch_port import port_model
    card = _temporal_card()
    jm = jax_model_random(card, seed=20)
    return jm, port_model(card, jm)


def test_chunk_pad_matches_jax_detect(temporal_models):
    """F = chunk + 2: the JAX package runs the short last chunk padded with
    copies of frame 0; the port does the same for a model that mixes frames.
    Without the pad the last frames' logits move by far more than the
    tolerance, so the pad is what makes them agree."""
    from videoseal_tpu_torch.models import videoseal as pvs
    jm, pm = temporal_models
    f = pm.cfg.chunk_size + 2
    x = np.random.default_rng(21).uniform(0, 1, (f, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.detect(x)["preds"])
    got = to_np(pm.detect(_t(x))["preds"])
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
    cdtype = pvs._DTYPES[pm.cfg.compute_dtype]
    with torch.no_grad():
        unpadded = to_np(pvs._chunked_apply(lambda b: pm.extractor(b[0].to(cdtype)).float(),
                                            (_t(x),), pm.cfg.chunk_size, pad_last=False))
    np.testing.assert_array_equal(unpadded[:-2], got[:-2])
    assert float(np.abs(unpadded[-2:] - want[-2:]).max()) > 5 * LOGIT_ATOL


def test_chunk_pad_matches_jax_embed(temporal_models):
    """The 2p1d embedder over 6 key frames (F = 12, step 2) in chunks of 4:
    the predictions against JAX's, f32 throughout."""
    jm, pm = temporal_models
    x = np.random.default_rng(22).uniform(0, 1, (12, 64, 64, 3)).astype(np.float32)
    m = np.random.default_rng(23).integers(0, 2, (1, NBITS)).astype(np.int32)
    want = jm.embed(x, msgs=m, is_video=True)
    got = pm.embed(_t(x), msgs=torch.from_numpy(m).long(), is_video=True)
    # K4's route returns the prediction before the full-resolution JND, the
    # JAX package's XLA route after it
    preds = pm.attenuation.heatmaps(_t(x)) * got["preds_w"]
    np.testing.assert_allclose(to_np(preds), np.asarray(want["preds_w"]), atol=1e-4)
    np.testing.assert_allclose(to_np(got["imgs_w"]), np.asarray(want["imgs_w"]), atol=1e-4)


def test_chunk_pad_only_for_frame_mixing_models():
    """A 2D model's short last chunk runs as it is: the pad is for models
    that mix frames."""
    from videoseal_tpu_torch.models.videoseal import VideoSeal, _chunked_apply
    seen = []
    out = _chunked_apply(lambda b: seen.append(b[0].shape[0]) or b[0] * 2,
                         (torch.arange(6.0),), 4)
    assert seen == [4, 2] and torch.equal(out, torch.arange(6.0) * 2)
    seen.clear()
    out = _chunked_apply(lambda b: seen.append(b[0].clone()) or b[0] * 2,
                         (torch.arange(6.0),), 4, pad_last=True)
    assert torch.equal(seen[1], torch.tensor([4.0, 5.0, 0.0, 0.0]))
    assert torch.equal(out, torch.arange(6.0) * 2)
    plain = VideoSeal.from_card(tiny_card(img_size=64), device="cpu")
    assert not common.mixes_frames(plain.embedder) and not common.mixes_frames(plain.extractor)
    temporal = VideoSeal.from_card(_temporal_card(), device="cpu")
    assert common.mixes_frames(temporal.embedder) and common.mixes_frames(temporal.extractor)


# -- the inflation script ------------------------------------------------------------

def test_inflate_matches_jax_and_keeps_the_output(tmp_path):
    """scripts/inflate_model_to_temporal on a port-written .npz: the tree
    equals the JAX package's inflate_tree of the same file; the model it
    names (the _2p1d preset) loads by path and embeds what the 2D model
    embeds, to 1e-6."""
    import videoseal_tpu_torch as vt
    from torch_port import tiny_preset_card
    from videoseal_tpu.scripts.inflate_model_to_temporal import inflate_tree
    from videoseal_tpu.utils.checkpoint import load_npz as jload_npz
    from videoseal_tpu_torch.utils.checkpoint import load_npz
    card, args = tiny_preset_card(img_size=64)
    args = dict(args, embedder_model="unet_small2_yuv_quant")
    card["embedder"] = {"model": "unet_small2_yuv_quant", "params": copy.deepcopy(
        vt.presets.EMBEDDER["unet_small2_yuv_quant"])}
    card["embedder"]["params"]["unet"].update(z_channels=4, num_blocks=1,
                                              z_channels_mults=[1, 2])
    model = vt.VideoSeal.from_card(card, device="cpu")
    src, dst = str(tmp_path / "2d.npz"), str(tmp_path / "2p1d.npz")
    vt.save_npz(src, model, args=args)
    subprocess.run([sys.executable, "-m", "videoseal_tpu_torch.scripts.inflate_model_to_temporal",
                    src, dst], check=True, cwd=ROOT, capture_output=True)
    emb, ext = load_npz(dst)
    jemb, jext = jload_npz(src)
    want = {c: inflate_tree(t) for c, t in jemb.items()}
    assert jax.tree_util.tree_structure(emb) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(emb), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(ext), jax.tree_util.tree_leaves(jext)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(dst) as data:
        new_args = json.loads(data["__args__"].tobytes().decode())
    assert new_args["embedder_model"] == "unet_small2_yuv_quant_2p1d"
    # the preset's widths cut as above, the inflated weights loaded into it
    card2 = copy.deepcopy(card)
    card2["embedder"]["params"]["unet"]["conv_layer"] = "conv2p1d"
    inflated = vt.VideoSeal.from_card(card2, checkpoint=dst, device="cpu")
    assert common.mixes_frames(inflated.embedder)
    x = torch.rand((6, 64, 64, 1), generator=torch.Generator().manual_seed(0))
    m = torch.randint(0, 2, (6, NBITS), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        np.testing.assert_allclose(to_np(inflated.embedder(x, m)), to_np(model.embedder(x, m)),
                                   atol=1e-6)
