"""K2's plain version against the Pallas kernel convnext_block_fused run in
interpret mode (f32 and bf16 inputs) and against the linen ConvNeXtBlock.
The CUDA kernel is held against the same plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoseal_tpu.kernels.convnext_block import convnext_block_fused as jax_block
from videoseal_tpu.modules.convnext import ConvNeXtBlock as LinenBlock
from videoseal_tpu_torch.kernels.convnext_block import (block_params,
                                                        convnext_block_fused,
                                                        convnext_block_plain)
from videoseal_tpu_torch.modules.convnext import ConvNeXtBlock
from videoseal_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

SHAPES = [(2, 8, 8, 16), (2, 16, 16, 32)]


def _setup(shape, seed):
    """Random x and linen block params (GRN randomised), the port block with
    the same weights."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    v = LinenBlock(c).init(jax.random.PRNGKey(seed), jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    p = {k: dict(val) for k, val in p.items()}
    p["grn"] = {"gamma": rng.normal(0, 0.3, 4 * c).astype(np.float32),
                "beta": rng.normal(0, 0.3, 4 * c).astype(np.float32)}
    p["dwconv"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    _, ext = from_jax_variables({"params": {"unet": {}}},
                                {"params": {"encoder": {"stage0_block0": p}}})
    blk = ConvNeXtBlock(c)
    pre = "convnext.stages.0.0."
    blk.load_state_dict({k[len(pre):]: t for k, t in ext.items()})
    return x, p, blk


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_f32(shape):
    x, p, blk = _setup(shape, 0)
    want = np.asarray(jax_block(jnp.asarray(x), p, interpret=True))
    got = convnext_block_plain(torch.from_numpy(x), block_params(blk)).numpy()
    # identical bf16 rounding points; the Pallas kernel's tanh GELU differs
    # from erf by <= 3e-4 per activation, which can flip a bf16 rounding of
    # the hidden activation (0.4% of it); the sums over 4C keep the output
    # within 2e-2 of the O(1) outputs
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.abs(got - want).mean() < 2e-3


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_bf16(shape):
    x, p, blk = _setup(shape, 1)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)
    want = np.asarray(jax_block(x16, p16, interpret=True), np.float32)
    blk16 = blk.to(torch.bfloat16)
    xt = torch.from_numpy(np.asarray(x16, np.float32)).to(torch.bfloat16)
    got = convnext_block_plain(xt, block_params(blk16))
    assert got.dtype == torch.bfloat16
    # as f32, plus the bf16 rounding of the output itself (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_linen_f32(shape):
    x, p, blk = _setup(shape, 2)
    want = np.asarray(LinenBlock(shape[-1]).apply({"params": p}, jnp.asarray(x)))
    got = blk(torch.from_numpy(x)).numpy()
    # the linen block is all f32; K2 rounds the pw1 input and the hidden
    # activation to bf16 (2^-9 relative each), as the TPU kernel does
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.abs(got - want).mean() < 5e-3


def test_cpu_wrapper_is_plain_and_counts_nothing():
    x, _, blk = _setup(SHAPES[0], 3)
    before = convnext_block_fused.launches
    a = convnext_block_fused(torch.from_numpy(x), block_params(blk))
    b = convnext_block_plain(torch.from_numpy(x), block_params(blk))
    assert torch.equal(a, b)
    assert convnext_block_fused.launches == before
