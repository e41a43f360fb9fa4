"""The port's blend (videoseal_tpu_torch.models.blender) against
videoseal_tpu.models.blender.blend, all four methods."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoseal_tpu.models.blender import blend as jax_blend
from videoseal_tpu_torch import blend

torch.set_num_threads(1)


@pytest.mark.parametrize("pred_c", [1, 3])
@pytest.mark.parametrize("method", ["additive", "multiplicative", "spatial_smoothed",
                                    "variance_based"])
def test_blend_matches_jax(method, pred_c):
    rng = np.random.default_rng(pred_c)
    imgs = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    preds = rng.uniform(-1, 1, (2, 12, 16, pred_c)).astype(np.float32)
    want = np.asarray(jax_blend(method, jnp.asarray(imgs), jnp.asarray(preds), 0.9, 0.3))
    got = blend(method, torch.from_numpy(imgs), torch.from_numpy(preds), 0.9, 0.3)
    assert tuple(got.shape) == want.shape == (2, 12, 16, 3)
    # f32 on both sides; the box sum and the variance sum in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown blending method"):
        blend("screen", torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 1), 1.0, 0.2)
