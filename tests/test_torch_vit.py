"""The port's SAM ViT (videoseal_tpu_torch.modules.vit) and videoseal_0.0's
SegmentationExtractor against the linen modules of videoseal_tpu.modules.vit
and models.extractor, f32, on weights carried across by from_jax_variables.
Every parameter is drawn from a numpy seed (the relative and absolute
position tables, which init at zero, too). Both sides compute attention in
f32 (the JAX package's einsums at "highest" precision, the port's matmuls on
the CPU): the tolerances cover summation order only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoseal_tpu.models.extractor import build_extractor as jax_build_extractor
from videoseal_tpu.modules import vit as jvit
from videoseal_tpu_torch.models.extractor import build_extractor
from videoseal_tpu_torch.modules import vit
from videoseal_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

ATOL = 1e-4


def _random_params(tree, rng):
    """Every leaf of a linen params tree redrawn: weights N(0, 0.1), LN
    scales around 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _random_params(dict(v), rng)
        elif k == "scale" or (k == "weight" and np.asarray(v).ndim == 1):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
    return out


def _carry(encoder_params: dict, prefix: str) -> dict:
    """The port's state dict for linen encoder params, cut below prefix."""
    _, sd = from_jax_variables({"params": {"unet": {}}}, {"params": {"encoder": encoder_params}})
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _init(module, x, seed):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return _random_params(jax.tree_util.tree_map(np.asarray, v["params"]),
                          np.random.default_rng(seed))


@pytest.mark.parametrize("q,k,length", [(4, 4, 7), (8, 8, 15), (5, 5, 7), (3, 5, 9),
                                        (6, 4, 7)])
def test_get_rel_pos(q, k, length):
    """Equal lengths (a table of 2 * max - 1 rows, gathered as it is) and
    unequal ones (the table resampled linearly first, the interpolation
    branch), with q != k too."""
    table = np.random.default_rng(q * 10 + k).normal(size=(length, 6)).astype(np.float32)
    want = np.asarray(jvit.get_rel_pos(q, k, jnp.asarray(table)))
    got = vit.get_rel_pos(q, k, torch.from_numpy(table)).numpy()
    assert got.shape == want.shape == (q, k, 6)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("shape,ws", [((2, 7, 10, 5), 4), ((1, 8, 8, 3), 4), ((2, 6, 5, 4), 3)])
def test_window_partition_round_trip(shape, ws):
    """Grids that the window does not divide are zero-padded at their
    bottom and right; unpartition cuts the padding off again."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    wj, pad_j = jvit.window_partition(jnp.asarray(x), ws)
    wt, pad_t = vit.window_partition(torch.from_numpy(x), ws)
    assert pad_t == tuple(pad_j)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    back = vit.window_unpartition(wt, ws, pad_t, shape[1:3])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jvit.window_unpartition(wj, ws, pad_j, shape[1:3])))


@pytest.mark.parametrize("size,hw", [((4, 4), (4, 4)), ((4, 4), (5, 3))])
def test_attention_with_rel_pos(size, hw):
    """Attention with the decomposed rel-pos bias, at its table's size and
    at another grid (the tables resampled)."""
    dim, heads = 24, 2
    x = np.random.default_rng(2).normal(size=(2, *hw, dim)).astype(np.float32)
    mod = jvit.Attention(dim, heads, True, True, input_size=size)
    params = _init(mod, x, 3)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    att = vit.Attention(dim, heads, True, True, size)
    att.load_state_dict(_carry({"block_0": {"attn": params}}, "image_encoder.blocks.0.attn."))
    with torch.no_grad():
        got = att(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("window", [0, 4])
def test_block(window):
    """A global block over the 6x6 grid, and a windowed one whose 4x4
    windows pad the grid to 8x8."""
    dim, heads, grid = 24, 2, 6
    x = np.random.default_rng(4).normal(size=(2, grid, grid, dim)).astype(np.float32)
    mod = jvit.Block(dim, heads, 4.0, True, True, window, input_size=(grid, grid))
    params = _init(mod, x, 5)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    blk = vit.Block(dim, heads, 4.0, True, True, window, (grid, grid))
    blk.load_state_dict(_carry({"block_0": params}, "image_encoder.blocks.0."))
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


ENC = dict(img_size=64, patch_size=16, embed_dim=48, depth=2, num_heads=2, out_chans=48,
           use_rel_pos=True, window_size=4, global_attn_indexes=(1,))


def test_image_encoder():
    x = np.random.default_rng(6).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mod = jvit.ImageEncoderViT(**ENC)
    params = _init(mod, x, 7)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    enc = vit.ImageEncoderViT(**ENC)
    enc.load_state_dict(_carry(params, "image_encoder."))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 48)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_segmentation_extractor():
    """The whole extractor as build_extractor("sam_small", ...) makes it in
    both packages: imgs * 2 - 1, the encoder, the bilinear pixel decoder ->
    (B, 1 + nbits) logits."""
    cfg = {"encoder": {k: v for k, v in ENC.items() if k != "img_size"},
           "pixel_decoder": {"pixelwise": False, "upscale_stages": [1],
                             "sigmoid_output": False, "upscale_type": "bilinear"}}
    x = np.random.default_rng(8).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    jspec = jax_build_extractor("sam_small", cfg, 64, 16)
    v = jspec.module.init(jax.random.PRNGKey(9), jnp.asarray(x))
    params = _random_params(jax.tree_util.tree_map(np.asarray, v["params"]),
                            np.random.default_rng(9))
    want = np.asarray(jspec.module.apply({"params": params}, jnp.asarray(x)))
    spec = build_extractor("sam_small", cfg, 64, 16)
    assert spec.module.pixel_decoder.linear.in_features == 48   # embed_dim from out_chans
    _, sd = from_jax_variables({"params": {"unet": {}}}, {"params": params})
    spec.module.load_state_dict(sd)
    with torch.no_grad():
        got = spec.module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 17)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_temporal_attention_raises():
    """Temporal attention no longer raises: the encoder builds a TemporalBlock
    after each block and pos_embed_temporal, and runs over a clip
    (tests/test_torch_temporal.py holds it against the linen module)."""
    enc = vit.ImageEncoderViT(**ENC, temporal_attention=True, max_temporal_length=8)
    assert len(enc.temp_blocks) == ENC["depth"]
    assert tuple(enc.pos_embed_temporal.shape) == (8, 1, 1, ENC["embed_dim"])
    assert tuple(enc.temp_blocks[0].attn.rel_pos.shape) == (15, ENC["embed_dim"] // 2)
    with torch.no_grad():
        out = enc(torch.rand((3, 64, 64, 3), generator=torch.Generator().manual_seed(0)))
    assert tuple(out.shape) == (3, 4, 4, ENC["out_chans"]) and bool(torch.isfinite(out).all())
