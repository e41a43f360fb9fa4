"""K2 at any width and any H*W (chunkyseal's stages): block_params pads a
block whose width is not a multiple of 16 with zeros, the plain version runs
the padded arithmetic with the LN's and GRN's statistics over the true
widths, and the extractor's route pads the activation once a stage. Held on
the CPU against the JAX package's plain block (`_block_xla`, the route the
JAX package takes for these shapes) and its `convnext_apply_fused`; the
CUDA kernels are held against the same plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from videoseal_tpu.kernels.convnext_fused import _block_xla
from videoseal_tpu.kernels.convnext_fused import convnext_apply_fused as jax_apply_fused
from videoseal_tpu.modules.convnext import ConvNeXtBlock as LinenBlock
from videoseal_tpu_torch.kernels import convnext_block as cb
from videoseal_tpu_torch.kernels.convnext_fused import block_groups, convnext_apply_fused
from videoseal_tpu_torch.modules.convnext import ConvNeXtBlock
from videoseal_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

# frames whose H*W is odd, widths whose C and 4C are not multiples of 16
SHAPES = [(3, 5, 7, 22), (3, 7, 9, 40), (2, 9, 11, 11)]


def _setup(shape, seed):
    """Random x and linen block params (GRN, LN and the dw bias randomised),
    the port block with the same weights."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    v = LinenBlock(c).init(jax.random.PRNGKey(seed), jnp.asarray(x))
    p = {k: dict(val) for k, val in jax.tree_util.tree_map(np.asarray, v["params"]).items()}
    p["grn"] = {"gamma": rng.normal(0, 0.3, 4 * c).astype(np.float32),
                "beta": rng.normal(0, 0.3, 4 * c).astype(np.float32)}
    p["dwconv"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    p["norm"] = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
                 "bias": rng.normal(0, 0.3, c).astype(np.float32)}
    _, ext = from_jax_variables({"params": {"unet": {}}},
                                {"params": {"encoder": {"stage0_block0": p}}})
    blk = ConvNeXtBlock(c)
    pre = "convnext.stages.0.0."
    blk.load_state_dict({k[len(pre):]: t for k, t in ext.items()})
    return x, p, blk


def test_padded_widths():
    assert [cb.padded_width(c) for c in (362, 724, 1448, 2896, 96, 11)] == [
        368, 736, 1456, 2896, 96, 16]


@pytest.mark.parametrize("shape", SHAPES)
def test_block_params_pad_with_zeros(shape):
    _, _, blk = _setup(shape, 1)
    p = cb.block_params(blk)
    c, cp = shape[-1], cb.padded_width(shape[-1])
    assert p["c"] == c == cb.true_width(p)
    assert p["dw"].shape == (49, cp) and p["w1"].shape == (4 * cp, cp)
    assert p["w2"].shape == (cp, 4 * cp) and p["gamma"].shape == (4 * cp,)
    for k in ("dw", "dwb", "lnw", "lnb", "b2"):
        assert not p[k][..., c:].any(), k
    for k in ("w1", "b1", "gamma", "beta"):
        assert not p[k][4 * c:].any(), k
    assert not p["w1"][:, c:].any() and not p["w2"][c:].any()
    assert not p["w2"][:, 4 * c:].any()
    assert torch.equal(p["w1"][:4 * c, :c], blk.pwconv1.weight.to(torch.bfloat16))


def test_aligned_widths_are_not_padded():
    p = cb.block_params(ConvNeXtBlock(32))
    assert "c" not in p and p["dw"].shape == (49, 32) and p["w1"].shape == (128, 32)


def _unpadded(p: dict, c: int) -> dict:
    """`block_params` p cut back to its true width c: the layout an aligned
    width has."""
    n = 4 * c
    cut = {"dw": p["dw"][:, :c], "w1": p["w1"][:n, :c], "w2": p["w2"][:c, :n]}
    cut |= {k: p[k][:c] for k in ("dwb", "lnw", "lnb", "b2")}
    cut |= {k: p[k][:n] for k in ("b1", "gamma", "beta")}
    return {k: v.contiguous() for k, v in cut.items()}


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_plain_matches_block_xla(shape):
    """The padded plain block at the true width's slice against the JAX
    package's plain block (f32, erf GELU); the pad channels come out 0, and
    the true channels are the unpadded arithmetic's bit for bit."""
    x, p, blk = _setup(shape, 2)
    want = np.asarray(_block_xla(jnp.asarray(x), p))
    kp = cb.block_params(blk)
    xp = F.pad(torch.from_numpy(x), (0, cb.padded_width(shape[-1]) - shape[-1]))
    out = cb.convnext_block_plain(xp, kp)
    c = shape[-1]
    assert not out[..., c:].any()
    assert torch.equal(out[..., :c], cb.convnext_block_plain(torch.from_numpy(x),
                                                             _unpadded(kp, c)))
    # the plain version rounds the pw1 input and the hidden activation to
    # bf16 (2^-9 relative) as the kernels do; _block_xla is all f32. With the
    # LN's affine drawn away from identity the outputs reach ~3, and the mean
    # error is ~2.4e-3 at the aligned widths' arithmetic too
    np.testing.assert_allclose(out[..., :c].numpy(), want, atol=2e-2, rtol=2e-2)
    assert np.abs(out[..., :c].numpy() - want).mean() < 3e-3
    # the module's forward at the true width pads and slices itself (on its
    # kernel route: under no_grad)
    with torch.no_grad():
        assert torch.equal(blk(torch.from_numpy(x)), out[..., :c])


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_padded_plain_bf16(shape):
    """bf16 activations: the same block within bf16's rounding of the
    output."""
    x, p, blk = _setup(shape, 3)
    want = np.asarray(_block_xla(jnp.asarray(x), p))
    kp = cb.block_params(blk.to(torch.bfloat16))
    xp = F.pad(torch.from_numpy(x).to(torch.bfloat16), (0, cb.padded_width(shape[-1]) - shape[-1]))
    out = cb.convnext_block_plain(xp, kp).float()
    c = shape[-1]
    assert not out[..., c:].any()
    np.testing.assert_allclose(out[..., :c].numpy(), want, atol=6e-2, rtol=3e-2)


def test_cuda_wrapper_refuses_an_unpadded_width():
    """K2's wrapper takes x at the parameters' padded width and checks it
    before it builds or launches anything; K3's takes no padded parameters
    and K2's old rule; both raise rather than run the plain version."""
    x, _, blk = _setup(SHAPES[0], 4)
    p = cb.block_params(blk)
    with pytest.raises(ValueError, match="padded width"):
        cb.k2_parts(torch.from_numpy(x), p)
    xp = F.pad(torch.from_numpy(x), (0, 10)).contiguous()
    with pytest.raises(ValueError, match="no padded"):
        cb._launch_group(xp, [p, p])
    with pytest.raises(ValueError, match="H\\*W % 16"):
        q = cb.block_params(ConvNeXtBlock(16))
        cb._launch_group(torch.zeros((1, 5, 5, 16)), [q, q])


def test_k3_rule_on_true_widths():
    """K3 keeps the rule it was held on: chunkyseal's stages run as K2
    launches on the grouped route."""
    for (h, w, c), d in zip(((127, 127, 362), (63, 63, 724), (31, 31, 1448), (15, 15, 2896)),
                            (3, 3, 27, 3)):
        assert not cb.k3_takes(h, w, c)
        assert block_groups(d, 4, (h, w, c)) == [1] * d


def _jax_encoder(dims, depths, stem_stride, s, seed):
    from videoseal_tpu.modules.convnext import ConvNeXtV2 as LinenConvNeXt
    enc = LinenConvNeXt(depths=depths, dims=dims, stem_stride=stem_stride)
    x = jnp.zeros((1, s, s, 3))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(enc.init)(jax.random.PRNGKey(seed), x)["params"])
    rng = np.random.default_rng(seed)
    params = {k: dict(v) for k, v in params.items()}
    for k, v in params.items():
        if "grn" in v:
            n = v["grn"]["gamma"].shape
            v["grn"] = {"gamma": rng.normal(0, 0.3, n).astype(np.float32),
                        "beta": rng.normal(0, 0.3, n).astype(np.float32)}
    return params


CHUNKY_CFG = {"proportional_dim": True,
              "encoder": {"stem_stride": 2, "depths": [2, 1, 2, 1], "dims": [32, 64, 128, 256]},
              "pixel_decoder": {"upscale_stages": [1], "sigmoid_output": False}}


@pytest.fixture(scope="module")
def chunky_encoder():
    """A narrow chunkyseal encoder's JAX params, input and JAX route output."""
    from videoseal_tpu.models.extractor import build_extractor as jax_build
    s, nbits = 64, 16
    enc = jax_build("convnext_chunky", CHUNKY_CFG, s, nbits).module.encoder
    dims, depths = tuple(enc["dims"]), tuple(enc["depths"])
    params = _jax_encoder(dims, depths, 2, s, 7)
    x = np.random.default_rng(8).uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    want = np.asarray(jax_apply_fused(params, jnp.asarray(x), depths=depths, dims=dims,
                                      stem_stride=2))
    return dims, params, x, want


@pytest.mark.parametrize("max_block_group", [1, 4])
def test_stem_stride_2_proportional_dims_match_jax(chunky_encoder, max_block_group):
    """A narrow chunkyseal encoder: stem 4x4 at stride 2 (VALID), dims
    [32, 64, 128, 256] scaled by sqrt(16 / 128) to [11, 22, 45, 90] (odd
    widths, odd H*W at every stage: 31, 15, 7, 3) through the port's route
    against the JAX package's convnext_apply_fused."""
    from videoseal_tpu_torch.models.extractor import build_extractor
    dims, params, x, want = chunky_encoder
    assert dims == (11, 22, 45, 90)
    port = build_extractor("convnext_chunky", CHUNKY_CFG, 64, 16).module
    _, sd = from_jax_variables({"params": {"unet": {}}}, {"params": {"encoder": params}})
    port.convnext.load_state_dict({k[len("convnext."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = convnext_apply_fused(port.convnext, torch.from_numpy(x), max_block_group)
    assert tuple(got.shape) == want.shape == (2, 3, 3, 90)
    # 6 blocks, each rounding its pw1 input and hidden activation to bf16
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=5e-2)
    assert np.abs(got.numpy() - want).mean() < 5e-3
