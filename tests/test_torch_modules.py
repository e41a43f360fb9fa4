"""Port modules against the linen modules at the tiny card, f32, with the
weights carried across by from_jax_variables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port import NBITS, jax_model, port_model, tiny_card, to_np

from videoseal_tpu.modules.jnd import JND as JaxJND
from videoseal_tpu.modules.pixel_decoder import PixelDecoder as LinenPixelDecoder
from videoseal_tpu_torch.modules.jnd import JND

torch.set_num_threads(1)

S = 64


@pytest.fixture(scope="module")
def models():
    card = tiny_card(img_size=S)
    jm = jax_model(card, seed=5)
    return jm, port_model(card, jm)


def test_embedder_matches_linen(models):
    jm, pm = models
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (3, S, S, 1)).astype(np.float32)
    m = rng.integers(0, 2, (3, NBITS)).astype(np.int32)
    want = np.asarray(jax.jit(jm.embedder_spec.module.apply)(
        jm.embedder_vars, jnp.asarray(x), jnp.asarray(m)))
    with torch.no_grad():
        got = pm.embedder(torch.from_numpy(x), torch.from_numpy(m).long())
    assert tuple(got.shape) == want.shape == (3, S, S, 1)
    # f32 convolutions on both sides; summation order only
    np.testing.assert_allclose(to_np(got), want, atol=2e-5)


def test_extractor_matches_linen(models):
    jm, pm = models
    x = np.random.default_rng(1).uniform(0, 1, (3, S, S, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.extractor_spec.module.apply)(jm.extractor_vars,
                                                              jnp.asarray(x)))
    with torch.no_grad():
        got = pm.extractor(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (3, 1 + NBITS)
    # every ConvNeXt block goes through K2, which rounds the pw1 input and the
    # hidden activation to bf16 (2^-9 relative) as the TPU kernel does; the
    # linen module is all f32
    np.testing.assert_allclose(to_np(got), want, atol=2e-2)


def test_pixel_decoder_matches_linen(models):
    jm, pm = models
    feats = np.random.default_rng(2).normal(size=(2, 2, 2, 64)).astype(np.float32)
    pd = LinenPixelDecoder(embed_dim=64, nbits=NBITS, upscale_stages=(1,))
    want = np.asarray(pd.apply({"params": jm.extractor_vars["params"]["pixel_decoder"]},
                               jnp.asarray(feats)))
    with torch.no_grad():
        got = pm.extractor.pixel_decoder(torch.from_numpy(feats))
    np.testing.assert_allclose(to_np(got), want, atol=1e-5)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 3), (4, 1), (2, 2), (3, 5)])
def test_reflect_pad_matches_jnp(h, w):
    """The Upsample's pad is jnp.pad's "reflect" at every size: a size-1
    axis repeats its value (nn.ReflectionPad2d raises there)."""
    from videoseal_tpu_torch.modules.common import ReflectPad1
    x = np.random.default_rng(h * 7 + w).normal(size=(2, 3, h, w)).astype(np.float32)
    want = np.pad(x, [(0, 0), (0, 0), (1, 1), (1, 1)], mode="reflect")
    np.testing.assert_array_equal(ReflectPad1()(torch.from_numpy(x)).numpy(), want)


def test_extractor_at_32px_matches_linen(models):
    """A 32-px input leaves convnext_tiny a 1x1 map before the pixel
    decoder's Upsample (factor 1, then the reflect pad): the port's
    differentiable route (module math, f32) against the linen module."""
    jm, pm = models
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.extractor_spec.module.apply)(jm.extractor_vars,
                                                              jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pm.extractor(xt)
    assert tuple(got.shape) == want.shape == (2, 1 + NBITS)
    np.testing.assert_allclose(to_np(got.detach()), want, atol=2e-5)


def test_proportional_dim_matches_jax():
    """chunkyseal's proportional_dim scales the ConvNeXt dims by
    sqrt(nbits / 128): the port's extractor has the JAX one's dims (the JAX
    weights load strictly) and its output."""
    from videoseal_tpu.models.extractor import build_extractor as jax_build
    from videoseal_tpu_torch.models.extractor import build_extractor
    card = tiny_card(img_size=S)
    params = card["extractor"]["params"]
    params["proportional_dim"] = True
    params["encoder"]["dims"] = [32, 64, 128, 256]
    want_dims = list(jax_build("convnext_tiny", params, S, NBITS).module.encoder["dims"])
    assert want_dims == [11, 22, 45, 90]     # int(d * sqrt(16 / 128))
    spec = build_extractor("convnext_tiny", params, S, NBITS)
    assert [stage[0].dwconv.in_channels for stage in spec.module.convnext.stages] == want_dims
    assert spec.module.pixel_decoder.linear.in_features == want_dims[-1]
    jm = jax_model(card, seed=6)
    pm = port_model(card, jm)                # load_state_dict is strict
    x = np.random.default_rng(7).uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.extractor_spec.module.apply)(jm.extractor_vars,
                                                              jnp.asarray(x)))
    with torch.no_grad():
        got = pm.extractor(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), want, atol=2e-2)  # as test_extractor_matches_linen


@pytest.mark.parametrize("io", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_jnd_heatmaps(io):
    x = np.random.default_rng(3).uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    want = np.asarray(JaxJND(*io).heatmaps(jnp.asarray(x)))
    got = JND(*io).heatmaps(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    # f32 stencils and pow on both sides; heat is in [0, ~0.1]
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_jnd_heatmap_lum():
    x = np.random.default_rng(4).uniform(0, 1, (3, 32, 48, 3)).astype(np.float32)
    x[0, :8] = 0.5  # flat region: the contrast term's floor
    want = np.asarray(JaxJND(1, 1).heatmap_lum(jnp.asarray(x)))
    got = JND(1, 1).heatmap_lum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(got, JND(1, 1).heatmaps(torch.from_numpy(x))[..., 0].numpy(),
                               atol=2e-6)
