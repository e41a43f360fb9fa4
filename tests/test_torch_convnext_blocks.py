"""K3 and the extractor's grouped route. K3's plain version against the
Pallas kernel convnext_blocks_fused run in interpret mode (bf16 and f32
input, with the erf GELU and its stated gap to the kernel's tanh form), the
same blocks with the tanh GELU against the kernel at a bound that only the
bf16 rounding between blocks meets, the grouped route
convnext_apply_fused(max_block_group=4) against the JAX package's, and the
grouping plan. The CUDA kernel is held against the same plain version, and
against sequential K2 launches, on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from videoseal_tpu.kernels.convnext_block import blocks_per_step
from videoseal_tpu.kernels.convnext_block import convnext_blocks_fused as jax_blocks
from videoseal_tpu.kernels.convnext_fused import convnext_apply_fused as jax_apply
from videoseal_tpu.models.extractor import build_extractor as jax_build_extractor
from videoseal_tpu.modules.convnext import ConvNeXtBlock as LinenBlock
from videoseal_tpu.modules.pixel_decoder import PixelDecoder as LinenPixelDecoder
from videoseal_tpu_torch.kernels.convnext_block import (block_params, block_plain_padded,
                                                        convnext_block_plain,
                                                        convnext_blocks_fused,
                                                        convnext_blocks_plain, k3_takes)
from videoseal_tpu_torch.kernels.convnext_fused import block_groups, convnext_apply_fused
from videoseal_tpu_torch.models.extractor import build_extractor
from videoseal_tpu_torch.modules.convnext import ConvNeXtBlock
from videoseal_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

SHAPE = (2, 16, 16, 32)
# K3 against the Pallas kernel: K2's tolerances (test_torch_convnext_block)
# over k blocks. The Pallas kernel's tanh GELU differs from erf by <= 3e-4
# per activation, which can flip a bf16 rounding of a hidden activation or
# of an intermediate block output (2^-8 relative); the sums over 4C keep
# each block within 2e-2 of its O(1) outputs, and the residual carries the
# error on, so k = 3 blocks get 3x that.
BLOCKS_TOL = {2: 4e-2, 3: 6e-2}
# grouped route logits, port vs JAX, both grouping [2], [2], [2], [2] or
# [2, 1] x 4: the per-block gap above through 8 or 12 blocks and the pixel
# decoder's mean pool and Linear, on logits of magnitude ~1
ROUTE_LOGIT_ATOL = 5e-2
# the grouped route against the single one on an f32 forward: the bf16
# rounding K3 makes between a group's blocks, carried through the later
# stages (measured 7.9e-3 on outputs up to 2.7)
ROUTE_F32_ATOL = 3e-2
# The same blocks with the kernel's tanh GELU, f32 input: only f32 sums in
# another order remain (measured mean 5e-7 at k = 2, 5e-6 at k = 3; max
# 1e-3, 4e-3). Without the bf16 rounding between blocks the mean is 2.5e-3
# and 4.4e-3, the max 2.4e-2 and 4.3e-2.
TANH_MEAN_TOL, TANH_MAX_TOL = 1e-4, 1e-2


def _linen_params(c: int, k: int, seed: int) -> list[dict]:
    """k linen ConvNeXtBlock parameter trees with GRN, LN and the dw bias
    randomised (their init values would hide bugs)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(k):
        v = LinenBlock(c).init(jax.random.PRNGKey(seed + j), jnp.zeros((1, 8, 8, c)))
        p = {name: dict(val) for name, val in
             jax.tree_util.tree_map(np.asarray, v["params"]).items()}
        p["grn"] = {"gamma": rng.normal(0, 0.3, 4 * c).astype(np.float32),
                    "beta": rng.normal(0, 0.3, 4 * c).astype(np.float32)}
        p["norm"] = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
                     "bias": rng.normal(0, 0.3, c).astype(np.float32)}
        p["dwconv"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        out.append(p)
    return out


def _port_params(plist: list[dict], dtype=torch.float32) -> list[dict]:
    """The same blocks as port `block_params`, through the weight bridge."""
    c = plist[0]["dwconv"]["bias"].shape[0]
    enc = {f"stage0_block{j}": p for j, p in enumerate(plist)}
    _, ext = from_jax_variables({"params": {"unet": {}}}, {"params": {"encoder": enc}})
    out = []
    for j in range(len(plist)):
        blk = ConvNeXtBlock(c)
        pre = f"convnext.stages.0.{j}."
        blk.load_state_dict({k[len(pre):]: t for k, t in ext.items() if k.startswith(pre)})
        out.append(block_params(blk.to(dtype)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 3])
def test_blocks_plain_matches_pallas(k, dtype):
    plist = _linen_params(SHAPE[-1], k, seed=10 * k)
    x = np.random.default_rng(k).normal(size=SHAPE).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jp = plist if dtype == "float32" else jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), plist)
    want = np.asarray(jax_blocks(jx, tuple(jp), interpret=True, k=k), np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    got = convnext_blocks_plain(xt, _port_params(plist, tdt))
    assert got.dtype == tdt and tuple(got.shape) == SHAPE
    np.testing.assert_allclose(got.float().numpy(), want, atol=BLOCKS_TOL[k],
                               rtol=BLOCKS_TOL[k])
    assert np.abs(got.float().numpy() - want).mean() < 3e-3 * k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_plain_matches_pallas_masked_shape(dtype):
    """12x20 frames: 240 pixels, not a multiple of 64, so K3's last M tile
    of every GEMM phase is masked on the card; the plain version against the
    Pallas kernel at k = 2."""
    shape, k = (2, 12, 20, 32), 2
    plist = _linen_params(shape[-1], k, seed=7)
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jp = plist if dtype == "float32" else jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), plist)
    want = np.asarray(jax_blocks(jx, tuple(jp), interpret=True, k=k), np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    got = convnext_blocks_plain(xt, _port_params(plist, tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=BLOCKS_TOL[k],
                               rtol=BLOCKS_TOL[k])
    assert np.abs(got.float().numpy() - want).mean() < 3e-3 * k


def _blocks_tanh(x: torch.Tensor, ps, between: torch.dtype) -> torch.Tensor:
    """The K3 plain chain with the tanh GELU, the intermediates in `between`."""
    pad = lambda t: F.pad(t, (0, 0, 3, 3, 3, 3))
    y = x
    for p in ps[:-1]:
        y = block_plain_padded(pad(y), p, between, act="tanh")
    return block_plain_padded(pad(y.to(x.dtype)), ps[-1], x.dtype, act="tanh")


@pytest.mark.parametrize("k", [2, 3])
def test_blocks_tanh_plain_matches_pallas_rounding_between_blocks(k):
    """f32 input, the kernel's tanh GELU: the plain chain with bf16 between
    blocks meets the tight bound; the chain without that rounding misses it."""
    plist = _linen_params(SHAPE[-1], k, seed=10 * k)
    x = np.random.default_rng(k).normal(size=SHAPE).astype(np.float32)
    want = np.asarray(jax_blocks(jnp.asarray(x), tuple(plist), interpret=True, k=k))
    ps = _port_params(plist)
    err = np.abs(_blocks_tanh(torch.from_numpy(x), ps, torch.bfloat16).numpy() - want)
    assert err.mean() < TANH_MEAN_TOL and err.max() < TANH_MAX_TOL
    unrounded = np.abs(_blocks_tanh(torch.from_numpy(x), ps, torch.float32).numpy() - want)
    assert unrounded.mean() > 10 * TANH_MEAN_TOL


@pytest.mark.parametrize("k", [2, 3])
def test_blocks_plain_rounds_between_blocks(k):
    """bf16 input: exactly k sequential K2 plain blocks. f32 input: the same
    with every intermediate rounded to bf16, the output in f32."""
    ps = _port_params(_linen_params(SHAPE[-1], k, seed=3))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=SHAPE).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float32):
        y = x.to(dtype)
        for p in ps[:-1]:
            y = convnext_block_plain(y, p).to(torch.bfloat16)
        want = convnext_block_plain(y.to(dtype), ps[-1])   # bf16 values, f32 math
        got = convnext_blocks_plain(x.to(dtype), ps)
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_blocks_cpu_wrapper_is_plain_and_counts_nothing():
    ps = _port_params(_linen_params(SHAPE[-1], 2, seed=5))
    x = torch.from_numpy(np.random.default_rng(6).normal(size=SHAPE).astype(np.float32))
    before = convnext_blocks_fused.launches
    assert torch.equal(convnext_blocks_fused(x, ps), convnext_blocks_plain(x, ps))
    assert convnext_blocks_fused.launches == before


@pytest.mark.parametrize("depths", [(2, 2, 2, 2), (3, 3, 3, 3)])
def test_grouped_route_matches_jax(depths):
    """convnext_apply_fused(max_block_group=4) plus the pixel decoder against
    the JAX package's, at 256x256 so that every stage (64^2 down to 8^2) is
    on the JAX kernel route."""
    dims, s, nbits = (8, 16, 32, 64), 256, 8
    cfg = {"encoder": {"depths": list(depths), "dims": list(dims)},
           "pixel_decoder": {"pixelwise": False, "upscale_stages": [1], "embed_dim": dims[-1],
                             "sigmoid_output": False}}
    spec = jax_build_extractor("convnext_tiny", cfg, s, nbits)
    rng = np.random.default_rng(sum(depths))
    x = rng.uniform(0, 1, (2, s, s, 3)).astype(np.float32)
    v = jax.jit(spec.module.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    for key, blk in params["encoder"].items():
        if "block" in key:
            c = blk["grn"]["gamma"].shape[-1]
            blk["grn"] = {"gamma": rng.normal(0, 0.3, c).astype(np.float32),
                          "beta": rng.normal(0, 0.3, c).astype(np.float32)}
    feats = jax_apply(params["encoder"], jnp.asarray(x) * 2 - 1, depths=depths, dims=dims,
                      interpret=True, max_block_group=4)
    want = np.asarray(LinenPixelDecoder(**spec.module.pixel_decoder).apply(
        {"params": params["pixel_decoder"]}, feats))

    ext = build_extractor("convnext_tiny", cfg, s, nbits).module
    ext.load_state_dict(from_jax_variables({"params": {"unet": {}}}, {"params": params})[1])
    with torch.no_grad():
        got = ext.pixel_decoder(convnext_apply_fused(ext.convnext,
                                                     torch.from_numpy(x) * 2 - 1,
                                                     max_block_group=4))
    assert tuple(got.shape) == want.shape == (2, 1 + nbits)
    np.testing.assert_allclose(got.numpy(), want, atol=ROUTE_LOGIT_ATOL)


def test_block_groups_videoseal():
    """videoseal_1.0's depths (3, 3, 9, 3): 5 groups of two or four (K3)
    and 4 single blocks (K2) per chunk with max_block_group=4; all single by
    default."""
    groups = [block_groups(d, 4) for d in (3, 3, 9, 3)]
    assert groups == [[2, 1], [2, 1], [4, 4, 1], [2, 1]]
    assert sum(k > 1 for g in groups for k in g) == 5
    assert sum(k == 1 for g in groups for k in g) == 4
    assert [block_groups(d) for d in (3, 3, 9, 3)] == [[1] * 3, [1] * 3, [1] * 9, [1] * 3]


@pytest.mark.parametrize("depth", range(1, 10))
def test_block_groups_match_jax_where_vmem_fits(depth):
    """Where the TPU's VMEM test passes (a small shape), the group size is
    the JAX package's blocks_per_step capped at max_block_group."""
    for cap in (1, 2, 3, 4):
        kmax = min(blocks_per_step(16, 16, 32, 1, depth), cap)
        groups = block_groups(depth, cap)
        assert sum(groups) == depth
        assert groups == [min(kmax, depth - kmax * i) for i in range(len(groups))]


def test_block_groups_rejects_zero():
    with pytest.raises(ValueError):
        block_groups(3, 0)


@pytest.mark.parametrize("shape", [(16, 64, 1024), (32, 60, 1024), (16, 16, 792), (8, 8, 200),
                                   (5, 5, 96)])
def test_block_groups_single_where_k3_cannot_go(shape):
    """A stage K3 does not take (K2's rule: 4*W*C over the 232,448 bytes of
    shared memory, C % 16 != 0, H*W % 16 != 0) runs in groups of one, K2
    launches, as the JAX route sizes such a stage's groups down to single
    blocks."""
    assert not k3_takes(*shape)
    for depth in (1, 3, 9):
        assert block_groups(depth, 4, shape) == [1] * depth


def test_block_groups_unchanged_where_k3_goes():
    """videoseal_1.0's four stages at 256 px, and stages with C > 768 that
    K2's rule takes, keep the grouping K3 takes."""
    for (h, w, c), d in zip(((64, 64, 96), (32, 32, 192), (16, 16, 384), (8, 8, 768)),
                            (3, 3, 9, 3)):
        assert block_groups(d, 4, (h, w, c)) == block_groups(d, 4)
    for shape in ((8, 8, 1536), (16, 16, 784), (12, 12, 1600), (4, 4, 1536), (8, 8, 1024)):
        assert k3_takes(*shape) and block_groups(3, 4, shape) == [2, 1]
    assert k3_takes(16, 56, 1024)   # 4*W*C = 229,376 bytes, just within


def test_grouped_route_sends_big_stages_to_k2(monkeypatch):
    """convnext_apply_fused(max_block_group=4) on an encoder whose last
    stage is 8x8x1024: K2's rule takes it (4*W*C = 32,768 bytes), so that
    stage's pair goes to K3 as the first stage's does, the single blocks
    between to K2, and the result is the single route's up to the bf16
    rounding K3 makes between the blocks of a group."""
    from videoseal_tpu_torch.kernels import convnext_fused as cf
    from videoseal_tpu_torch.models.videoseal import init_weights
    from videoseal_tpu_torch.modules.convnext import ConvNeXtV2
    enc = ConvNeXtV2(depths=(2, 1, 1, 2), dims=(16, 32, 64, 1024)).eval()
    init_weights(enc, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (1, 256, 256, 3))
                         .astype(np.float32))
    calls = []
    k2, k3 = cf.convnext_block_fused, cf.convnext_blocks_fused
    monkeypatch.setattr(cf, "convnext_block_fused",
                        lambda y, p: calls.append(("K2", y.shape[-1])) or k2(y, p))
    monkeypatch.setattr(cf, "convnext_blocks_fused",
                        lambda y, ps: calls.append(("K3", y.shape[-1])) or k3(y, ps))
    with torch.no_grad():
        got = convnext_apply_fused(enc, x, max_block_group=4)
        grouped_calls, calls[:] = list(calls), []
        want = convnext_apply_fused(enc, x, max_block_group=1)
    assert grouped_calls == [("K3", 16), ("K2", 32), ("K2", 64), ("K3", 1024)]
    assert tuple(got.shape) == (1, 8, 8, 1024)
    # K3's plain version rounds the first block's output to bf16 (2^-9
    # relative) before the second; the later stages carry that through LN
    # and the products as a relative error of the same order
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ROUTE_F32_ATOL)
