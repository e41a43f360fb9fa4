"""The attribution probes' plain versions against the JAX package's Pallas
probe kernels run in interpret mode: K7 (kernels/jnd_probe.py, four
variants of the JND delta on f32 and u8 frames) and K8
(kernels/convnext_probe.py, nine variants of the ConvNeXt block and the
production block). Each JAX kernel is wrapped in pl.pallas_call exactly as
its probe's `run` wraps it. The CUDA kernels are held against the same plain
versions on the card by chip_smoke.py."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from videoseal_tpu.kernels import convnext_probe as jcp
from videoseal_tpu.kernels import jnd_probe as jjp
from videoseal_tpu.kernels.convnext_block import convnext_block_fused as jax_block
from videoseal_tpu_torch.kernels import convnext_probe as tcp
from videoseal_tpu_torch.kernels import fused_blend as tfb
from videoseal_tpu_torch.kernels import jnd_probe as tjp

torch.set_num_threads(1)

# K7: F=2 frames of 16 x 128 (one 128-lane block), JAX row tile 8
F, H, W, TH, SW = 2, 16, 128, 8, 0.2
# the plain versions repeat the TPU probe's f32 arithmetic with the sums in
# the same order: ~1e-6 relative to the largest output (copy's outputs reach
# 0.2 * 255, sums' 0.2 * (la + cm2) ~ 1e5, the heat's deltas ~0.02)
K7_RTOL = 1e-5
# K8 at 2 x 8 x 8 x 16. The depthwise-only outputs are one bf16 rounding of
# the same sums (one bf16 ulp of |x| <= 4). The blocks as K2's test against
# the Pallas kernel (test_torch_convnext_block: identical bf16 rounding
# points, f32 sums in another order can flip a bf16 rounding, 2^-8
# relative); "block_gelu" and "production_block" are erf here and tanh in
# the Pallas kernels, <= 3e-4 per activation, which flips such roundings
# more often. "block_gelu_tanh_bf16dw" chains 49 bf16 products and sums
# inside a larger XLA fusion, which may keep f32 between them (XLA's
# excess-precision default) where the port rounds each: one bf16 ulp of the
# O(4) outputs (0.03125) on outputs near 0.
K8_TOL = {"dw": 1.6e-2, "block": 3e-2, "block_bf16dw": 4e-2}


def _jnd_inputs(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        imgs = rng.integers(0, 256, (F, H, W, 3), np.uint8)
    else:
        imgs = rng.uniform(0, 1, (F, H, W, 3)).astype(np.float32)
    pred = rng.uniform(-1, 1, (F, H, W)).astype(np.float32)
    return imgs, pred


def _jax_jnd_probe(mode: str, imgs: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """jnd_probe._build's kernel on the luminance plane that
    fused_blend.fused_jnd_delta builds (fused_blend.py:474-480)."""
    sc = 255.0 if imgs.dtype != np.uint8 else 1.0
    x = jnp.asarray(imgs).astype(jnp.float32)
    lum = x[..., 0] * (0.299 * sc) + x[..., 1] * (0.587 * sc) + x[..., 2] * (0.114 * sc)
    wq = -(-W // 128) * 128
    wp = wq + 128
    lum = jnp.pad(lum, ((0, 0), (4, 4), (2, wp - W - 2)))
    pred_p = jnp.pad(jnp.asarray(pred), ((0, 0), (0, 0), (0, wq - W)))
    n_tiles = H // TH
    kern = jjp._build(mode, TH, wq, wp, n_tiles, F * n_tiles)
    out = pl.pallas_call(
        kern,
        grid=(F, n_tiles),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, TH, wq), lambda fi, i: (fi, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((F, H, wq), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, TH + 8, wp), jnp.float32),
                        pltpu.VMEM((2, TH, wq), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,)),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True,
    )(jnp.reshape(jnp.float32(SW), (1,)), lum, pred_p)
    return np.asarray(out)[..., :W]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("mode", tjp.MODES)
def test_jnd_probe_plain_matches_pallas(mode, dtype):
    imgs, pred = _jnd_inputs(dtype, seed=tjp.MODES.index(mode))
    want = _jax_jnd_probe(mode, imgs, pred)
    got = tjp.jnd_probe(torch.from_numpy(imgs), torch.from_numpy(pred), SW, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (F, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=K7_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_jnd_probe_production_is_k5(dtype):
    """full_nosqrt is K5's delta, and the strip height changes no result."""
    imgs, pred = (torch.from_numpy(a) for a in _jnd_inputs(dtype, seed=7))
    want = tfb.fused_jnd_delta(imgs, pred, SW)
    for rs in tjp.RS_SWEEP:
        assert torch.equal(tjp.jnd_probe(imgs, pred, SW, "full_nosqrt", rs), want)


def test_jnd_probe_cpu_counts_nothing_and_checks_its_arguments():
    imgs, pred = (torch.from_numpy(a) for a in _jnd_inputs("float32", seed=8))
    before = tjp.jnd_probe.launches
    tjp.jnd_probe(imgs, pred, SW, "copy")
    assert tjp.jnd_probe.launches == before
    with pytest.raises(ValueError):
        tjp.jnd_probe(imgs, pred, SW, "full", rs=12)
    with pytest.raises(ValueError):
        tjp.jnd_probe(imgs, pred, SW, "cm")


def _cnx_inputs(b=2, h=8, w=8, c=16, seed=0):
    """The TPU probe's input kinds (convnext_probe.run) in numpy: bf16 x with
    a random halo, dw and weights from normals, one vector of each width."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return {"x": bf(rng.normal(0, 1, (b, h + 6, w + 6, c))),
            "dw": rng.normal(0, 0.1, (7, 7, c)).astype(np.float32),
            "vc": rng.normal(0, 1, (c,)).astype(np.float32),
            "w1": bf(rng.normal(0, 0.05, (c, 4 * c))),
            "v4": rng.normal(0, 1, (4 * c,)).astype(np.float32),
            "w2": bf(rng.normal(0, 0.05, (4 * c, c)))}


def _jax_cnx_probe(variant: str, a: dict) -> np.ndarray:
    b, hp, wp, c = a["x"].shape
    h, w = hp - 6, wp - 6
    vc, v4 = jnp.asarray(a["vc"]), jnp.asarray(a["v4"])
    w1 = jnp.asarray(a["w1"], jnp.bfloat16)
    w2 = jnp.asarray(a["w2"], jnp.bfloat16)
    if variant == "production_block":
        # the TPU probe's reference: K2's Pallas kernel (zero halo)
        p = {"dwconv": {"kernel": jnp.asarray(a["dw"]).reshape(7, 7, 1, c), "bias": vc},
             "norm": {"weight": vc, "bias": vc}, "pwconv1": {"kernel": w1, "bias": v4},
             "grn": {"gamma": v4, "beta": v4}, "pwconv2": {"kernel": w2, "bias": vc}}
        x = jnp.asarray(a["x"][:, 3:3 + h, 3:3 + w], jnp.bfloat16)
        return np.asarray(jax_block(x, p, interpret=True), np.float32)
    vm = lambda shape, imap: pl.BlockSpec(shape, imap, memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(jcp.build(variant), h=h, w=w, c=c),
        grid=(b,),
        in_specs=[vm((1, h + 6, w + 6, c), lambda i: (i, 0, 0, 0)),
                  vm((7, 7, c), lambda i: (0, 0, 0)),
                  vm((c,), lambda i: (0,)), vm((c,), lambda i: (0,)), vm((c,), lambda i: (0,)),
                  vm((c, 4 * c), lambda i: (0, 0)), vm((4 * c,), lambda i: (0,)),
                  vm((4 * c,), lambda i: (0,)), vm((4 * c,), lambda i: (0,)),
                  vm((4 * c, c), lambda i: (0, 0)), vm((c,), lambda i: (0,))],
        out_specs=vm((1, h, w, c), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, w, c), jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["dw"]), vc, vc, vc, w1, v4, v4, v4,
      w2, vc)
    return np.asarray(out, np.float32)


def _port_cnx_inputs(a: dict):
    c = a["vc"].shape[0]
    t = lambda arr: torch.from_numpy(np.array(arr))
    vc, v4 = t(a["vc"]), t(a["v4"])
    p = {"dw": t(a["dw"].reshape(49, c)), "dwb": vc, "lnw": vc, "lnb": vc,
         "w1": t(a["w1"].T).to(torch.bfloat16), "b1": v4, "gamma": v4, "beta": v4,
         "w2": t(a["w2"].T).to(torch.bfloat16), "b2": vc}
    xpad = t(a["x"]).to(torch.bfloat16)
    if "production" in a:
        xpad = torch.nn.functional.pad(xpad[:, 3:-3, 3:-3], (0, 0, 3, 3, 3, 3))
    return xpad, p


@pytest.mark.parametrize("variant", list(tcp.VARIANTS))
def test_convnext_probe_plain_matches_pallas(variant):
    a = _cnx_inputs(seed=list(tcp.VARIANTS).index(variant))
    if variant == "production_block":
        a["production"] = True
    want = _jax_cnx_probe(variant, a)
    xpad, p = _port_cnx_inputs(a)
    got = tcp.convnext_probe(xpad, p, variant)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    form, _, dw_only = tcp.VARIANTS[variant]
    tol = K8_TOL["dw" if dw_only else "block_bf16dw" if form == "bf16" else "block"]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("variant", ["block_gelu", "block_gelu_tanh_bf16dw"])
def test_convnext_probe_plain_matches_pallas_masked(variant):
    """A block variant on a padded input whose halo is data, at 12x20 (240
    pixels: the card's last M tiles masked, the padded residual read with a
    row pitch of W + 6 that no tile boundary follows)."""
    a = _cnx_inputs(b=2, h=12, w=20, c=16, seed=20 + list(tcp.VARIANTS).index(variant))
    want = _jax_cnx_probe(variant, a)
    xpad, p = _port_cnx_inputs(a)
    assert float(xpad[:, :3].abs().max()) > 0   # the halo is data
    got = tcp.convnext_probe(xpad, p, variant)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 12, 20, 16)
    form = tcp.VARIANTS[variant][0]
    tol = K8_TOL["block_bf16dw" if form == "bf16" else "block"]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_convnext_probe_production_is_k2():
    """production_block on a zero halo is K2's plain block; the CPU wrapper
    counts nothing."""
    from videoseal_tpu_torch.kernels.convnext_block import convnext_block_plain
    xpad, p = _port_cnx_inputs(dict(_cnx_inputs(seed=11), production=True))
    before = tcp.convnext_probe.launches
    got = tcp.convnext_probe(xpad, p, "production_block")
    assert tcp.convnext_probe.launches == before
    assert torch.equal(got, convnext_block_plain(xpad[:, 3:-3, 3:-3].contiguous(), p))
    with pytest.raises(ValueError):
        tcp.convnext_probe(xpad, p, "block_relu")
