"""The port's mask samplers (videoseal_tpu_torch.augmentation.masks on the
device, masks_host on the host) against the JAX package's: the same draws
give the same rects and outpaint masks, the blob through JAX's bicubic
weights, and the host generators bit for bit on the same numpy generator."""

import numpy as np
import pytest
import torch

import jax

from videoseal_tpu.augmentation import masks as JM
from videoseal_tpu.augmentation import masks_host as JH
from videoseal_tpu_torch.augmentation import masks as PM
from videoseal_tpu_torch.augmentation import masks_host as PH

torch.set_num_threads(1)

# the blob's bicubic upsample: the same float32 weights, the two matmuls'
# sums in another order, so a pixel whose sigmoid lands within an ulp of 0.5
# can round the other way
BLOB_MISMATCH = 1e-3
# JAX's weight matrix against the numpy copy: float32 sums in another order
WEIGHT_ATOL = 1e-6


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("h,w", [(64, 96), (37, 50)])
def test_rect_and_outpaint_equal_jax_at_the_same_draws(seed, h, w):
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    for lo, hi, jfn in ((0.2, 0.8, lambda: JM._rect_mask(key, h, w)),
                        (0.4, 0.9, lambda: 1.0 - JM._outpaint_mask(key, h, w))):
        fh = float(jax.random.uniform(k1, (), minval=lo, maxval=hi))
        fw = float(jax.random.uniform(k2, (), minval=lo, maxval=hi))
        ut, ul = float(jax.random.uniform(k3, ())), float(jax.random.uniform(k4, ()))
        got = PM.rect_from(h, w, fh, fw, ut, ul).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfn()))
        assert 0 < got.mean() < 1


@pytest.mark.parametrize("n_in,n_out", [(2, 64), (3, 96), (2, 37), (5, 160)])
def test_bicubic_weights_match_jax(n_in, n_out):
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat
    want = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_keys_cubic_kernel, True)
    np.testing.assert_allclose(PM.keys_cubic_matrix(n_in, n_out), np.asarray(want),
                               atol=WEIGHT_ATOL)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("h,w", [(64, 96), (128, 160)])
def test_blob_matches_jax_from_the_same_noise(seed, h, w):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    coarse = np.asarray(jax.random.normal(k1, (max(h // 32, 2), max(w // 32, 2))))
    thr = float(jax.random.uniform(k2, (), minval=-0.5, maxval=0.8))
    want = np.asarray(JM._blob_mask(key, h, w))
    got = PM.blob_from(torch.as_tensor(coarse.copy()), thr, h, w).numpy()
    assert got.shape == want.shape and set(np.unique(got)) <= {0.0, 1.0}
    assert (got != want).mean() < BLOB_MISMATCH


@pytest.mark.parametrize("kind", ["none", "full", "rect", "blob", "outpaint", "mixed"])
def test_sampler_kinds(kind):
    g = torch.Generator().manual_seed(0)
    imgs = torch.zeros((6, 48, 64, 3))
    sampler = PM.build_mask_sampler({"kind": kind})
    m = sampler(g, imgs, None)
    assert tuple(m.shape) == (6, 48, 64, 1) and set(torch.unique(m).tolist()) <= {0.0, 1.0}
    if kind in ("none", "full"):
        assert bool((m == 1).all())
    elif kind != "mixed":
        assert 0 < float(m.mean()) < 1


def test_sampler_invert_segmentation_and_representatives():
    g = torch.Generator().manual_seed(1)
    imgs = torch.zeros((64, 16, 16, 3))
    inv = PM.build_mask_sampler({"kind": "rect", "invert_proba": 1.0})(g, imgs, None)
    g = torch.Generator().manual_seed(1)
    plain = PM.build_mask_sampler({"kind": "rect"})(g, imgs, None)
    # inversion draws after the rects: the same rects, inverted
    torch.testing.assert_close(inv, 1.0 - plain)
    seg = torch.rand((64, 16, 16, 1))
    assert PM.build_mask_sampler({"kind": "segmentation"})(g, imgs, seg) is seg
    assert bool((PM.build_mask_sampler({"kind": "segmentation"})(g, imgs, None) == 1).all())
    reps = PM.sample_representative_masks(g, 32, 48)
    assert tuple(reps.shape) == (4, 32, 48, 1) and bool((reps[0] == 1).all())
    with pytest.raises(ValueError, match="mask kind"):
        PM.build_mask_sampler({"kind": "star"})


# -- the host generators ---------------------------------------------------------------

_HOST_CALLS = [
    ("make_random_irregular_mask", {"max_times": 6, "min_times": 2}),
    ("make_random_irregular_mask", {"draw_method": "circle", "min_times": 2}),
    ("make_random_irregular_mask", {"draw_method": "square", "min_times": 2}),
    ("make_random_rectangle_mask", {"min_times": 1, "max_times": 4}),
    ("make_random_superres_mask", {}),
    ("make_outpainting_mask", {}),
]


@pytest.mark.parametrize("case", range(len(_HOST_CALLS)))
def test_host_masks_bit_equal(case):
    name, kw = _HOST_CALLS[case]
    for seed in range(3):
        got = getattr(PH, name)((96, 128), rng=np.random.default_rng(seed), **kw)
        want = getattr(JH, name)((96, 128), rng=np.random.default_rng(seed), **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_host_mixed_embedder_bit_equal():
    kw = dict(seed=5, outpainting_proba=0.2, superres_proba=0.2, squares_proba=0.1)
    pe, je = PH.get_mask_embedder("mixed", **kw), JH.get_mask_embedder("mixed", **kw)
    imgs = np.zeros((3, 64, 80, 3), np.float32)
    seg = np.random.default_rng(0).integers(0, 2, (3, 64, 80, 1)).astype(np.float32)
    for i in range(12):
        masks = seg if i % 2 else None
        np.testing.assert_array_equal(pe(imgs, masks), je(imgs, masks))
    np.testing.assert_array_equal(pe.sample_representative_masks(64, 80),
                                  je.sample_representative_masks(64, 80))
    np.testing.assert_array_equal(PH.get_mask_embedder("none")(imgs),
                                  JH.get_mask_embedder("none")(imgs))
