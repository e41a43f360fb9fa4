"""K2's four parts (dwln, pw1, grn_stats, pw2) on the CPU: their plain
versions composed are K2's plain block bit for bit, GRN's statistics from
the kernel's per-(frame, M tile) partials match the per-frame sums, the
wrapper's shape check, the cached parameter layout, and the CPU wrapper.
The CUDA kernels are held against the same plain parts on the card by
chip_smoke.py; K2's plain block is held against the Pallas kernel in
tests/test_torch_convnext_block.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port import tiny_card
from videoseal_tpu_torch.kernels.convnext_block import (_check_shape, block_params,
                                                        block_plain_padded,
                                                        convnext_block_fused,
                                                        convnext_block_plain, dwln_plain,
                                                        grn_stats_plain, kernel_params,
                                                        pw1_plain, pw2_plain)
from videoseal_tpu_torch.models.videoseal import VideoSeal
from videoseal_tpu_torch.modules.convnext import ConvNeXtBlock

torch.set_num_threads(1)

SHAPES = [(2, 8, 8, 16), (2, 16, 16, 32), (3, 12, 20, 16)]


def _block(c: int, seed: int, dtype=torch.float32) -> ConvNeXtBlock:
    """A block with every parameter drawn from a seeded numpy generator (GRN
    and LN away from their init values, which would hide faults)."""
    rng = np.random.default_rng(seed)
    blk = ConvNeXtBlock(c)
    with torch.no_grad():
        for name, t in blk.named_parameters():
            std = 0.3 if ("grn" in name or "norm" in name) else 0.1
            t.copy_(torch.from_numpy(rng.normal(0, std, t.shape).astype(np.float32)))
        blk.norm.weight.add_(1.0)
    return blk.to(dtype)


def _x(shape, seed: int, dtype) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_parts_compose_to_plain_block(shape, dtype):
    p = block_params(_block(shape[-1], 1, dtype))
    x = _x(shape, 2, dtype)
    a = dwln_plain(x, p)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == (np.prod(shape[:3]), shape[-1])
    hid, sums = pw1_plain(a, p, shape[0])
    assert hid.dtype == torch.bfloat16 and tuple(hid.shape) == (a.shape[0], 4 * shape[-1])
    gn = grn_stats_plain(sums, p["gamma"])
    assert gn.dtype == torch.float32 and tuple(gn.shape) == (shape[0], 4 * shape[-1])
    got = pw2_plain(hid, gn, p, x, x.dtype)
    assert got.dtype == dtype and tuple(got.shape) == shape
    # the padded block (K3's and the K8 probe's plain versions) on a zero halo
    want = block_plain_padded(F.pad(x, (0, 0, 3, 3, 3, 3)), p, x.dtype)
    assert torch.equal(got, want)
    assert torch.equal(convnext_block_plain(x, p), want)


def _partials(hid: torch.Tensor, frames: int, bm: int) -> torch.Tensor:
    """pw1's partials as the kernel lays them out: per frame, per frame-local
    M tile of bm rows (the last one masked to the frame's end), per column,
    the sum of the bf16 hidden's squares."""
    hf = hid.float().view(frames, -1, hid.shape[-1])
    hw = hf.shape[1]
    out = []
    for t0 in range(0, hw, bm):
        s = torch.zeros(frames, hid.shape[-1])
        for r in range(t0, min(t0 + bm, hw)):
            s = s + hf[:, r] * hf[:, r]
        out.append(s)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("shape", [(3, 12, 20, 16), (2, 16, 16, 32)])
def test_grn_stats_from_tile_partials(shape, bm):
    """(3, 12, 20): 240 pixels a frame, so the last tile is masked (112 or 48
    rows); (2, 16, 16): 256, whole tiles."""
    p = block_params(_block(shape[-1], 3))
    b = shape[0]
    hid, sums = pw1_plain(dwln_plain(_x(shape, 4, torch.float32), p), p, b)
    part = _partials(hid, b, bm)
    assert part.shape[1] == -(-shape[1] * shape[2] // bm)
    # f32 sums in another order than the direct per-frame ones
    np.testing.assert_allclose(part.sum(dim=1).numpy(), sums.numpy(), rtol=1e-6)
    np.testing.assert_allclose(grn_stats_plain(part, p["gamma"]).numpy(),
                               grn_stats_plain(sums, p["gamma"]).numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(1, 8, 8, 24), (1, 8, 8, 8), (1, 5, 5, 20), (2, 3, 6, 40)])
def test_shape_check_raises(shape):
    """A width C % 16 != 0: the kernels take it only padded (block_params
    pads the parameters, the caller the activation), at any H*W."""
    with pytest.raises(ValueError):
        _check_shape(*shape)


@pytest.mark.parametrize("shape,want", [
    ((32, 64, 64, 96), 128), ((32, 8, 8, 768), 64), ((1, 8, 8, 784), 64),
    ((2, 16, 16, 1536), 128), ((3, 12, 20, 96), 128), ((2, 4, 4, 16), 64),
    ((1, 5, 5, 16), 64), ((2, 3, 6, 32), 64), ((4, 127, 127, 368), 128),
    ((4, 63, 63, 736), 128), ((4, 31, 31, 1456), 128), ((4, 15, 15, 2896), 128)])
def test_shape_check_takes(shape, want):
    """The extractor's stages, C > 768 (no longer capped), a ragged frame,
    a frame of 16 pixels, frames whose H*W is not a multiple of 16, and
    chunkyseal's four stages at their padded widths: the GEMMs' frame-local
    M tile."""
    assert _check_shape(*shape) == want


def test_shape_check_raises_past_shared_memory():
    """One image row of f32 dw output must fit shared memory."""
    with pytest.raises(ValueError):
        _check_shape(1, 16, 64, 1024)


def test_kernel_params_cached_and_rebuilt():
    blk = _block(16, 5)
    p = kernel_params(blk)
    assert kernel_params(blk) is p
    assert all(torch.equal(p[k], v) for k, v in block_params(blk).items())
    with torch.no_grad():
        blk.pwconv1.weight.mul_(2.0)           # in-place update: _version moves
    q = kernel_params(blk)
    assert q is not p and torch.equal(q["w1"], blk.pwconv1.weight.to(torch.bfloat16))
    assert kernel_params(blk) is q
    blk.to(torch.bfloat16)                     # .to: new storage and dtype
    r = kernel_params(blk)
    assert r is not q and kernel_params(blk) is r
    assert torch.equal(r["b1"], blk.pwconv1.bias.float())


def test_kernel_params_rebuilt_after_with_dtype():
    model = VideoSeal.from_card(tiny_card(img_size=64), device="cpu")
    blk = model.extractor.convnext.stages[0][0]
    p = kernel_params(blk)
    m16 = model.with_dtype("bfloat16")
    blk16 = m16.extractor.convnext.stages[0][0]
    q = kernel_params(blk16)
    assert q is not p and kernel_params(blk16) is q
    # stage 0 of the tiny card is 8 wide: K2's layout pads it to 16 channels
    dw = blk16.dwconv.weight.float().reshape(-1, 49).t()
    assert torch.equal(q["dw"], F.pad(dw, (0, 16 - dw.shape[1]))) and q["c"] == 8
    assert kernel_params(blk) is p    # the original keeps its own


def test_block_forward_uses_the_cache():
    blk = _block(16, 6)
    x = _x((2, 8, 8, 16), 7, torch.float32)
    with torch.no_grad():    # the kernel route (grad enabled takes the linen math)
        y = blk(x)
        p = blk.__dict__["_kernel_params"][1]
        assert torch.equal(blk(x), y) and blk.__dict__["_kernel_params"][1] is p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_is_plain_and_counts_nothing(dtype):
    shape = SHAPES[-1]
    p = kernel_params(_block(shape[-1], 8, dtype))
    x = _x(shape, 9, dtype)
    before = convnext_block_fused.launches
    assert torch.equal(convnext_block_fused(x, p), convnext_block_plain(x, p))
    assert convnext_block_fused.launches == before
