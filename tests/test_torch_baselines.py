"""The TorchScript baselines of the port against the JAX package's wrapper on
the CPU, and the layout and image helpers: for each of the five methods,
small scripted embedders and extractors (one giving the detection channel,
one not) at the method's processing size; embed, detect and extract_message
against ``videoseal_tpu.models.baselines``; the message draws; the errors of
``load("baseline/...")``; ``utils/layout`` and ``utils/image`` against
``videoseal_tpu.utils``'s."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import videoseal_tpu as vs
import videoseal_tpu_torch as vt
from videoseal_tpu.models import baselines as jbaselines
from videoseal_tpu.utils import image as jimage, layout as jlayout
from videoseal_tpu_torch.models import baselines
from videoseal_tpu_torch.utils import image, layout

torch.set_num_threads(1)

# f32 on both sides: the resizes' matmuls sum in another order
ATOL = 1e-5
METHODS = sorted(baselines._BASELINE_SPECS)


class Enc(torch.nn.Module):
    """A residual that depends on the image and the message."""

    def __init__(self, nbits: int):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)
        self.msg = torch.nn.Linear(nbits, 3)

    def forward(self, x, m):
        return x + 0.1 * torch.tanh(self.conv(x) + self.msg(m)[:, :, None, None])


class Dec(torch.nn.Module):
    def __init__(self, nbits: int, with_detect: bool):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=2)
        self.head = torch.nn.Linear(8, nbits + int(with_detect))

    def forward(self, x):
        return self.head(torch.relu(self.conv(x)).mean(dim=(2, 3)))


def _scripted(tmp_path, method: str, with_detect: bool) -> tuple[str, str, int]:
    nbits = baselines._DEFAULT_BITS[method]
    torch.manual_seed(0)
    ep, dp = str(tmp_path / "enc.jit.pt"), str(tmp_path / "dec.jit.pt")
    torch.jit.script(Enc(nbits)).save(ep)
    torch.jit.script(Dec(nbits, with_detect)).save(dp)
    return ep, dp, nbits


@pytest.mark.parametrize("with_detect", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_baseline_matches_jax(method, with_detect, tmp_path):
    """Each method's normalisation (pm1, imnet, none), processing size and
    scaling_w: embed (image and video) and detect against the JAX
    wrapper's within float32 rounding, the zero detection column where the
    export gives the bits alone, extract_message's bits equal, and the
    messages drawn from the same seeded numpy generator."""
    ep, dp, nbits = _scripted(tmp_path, method, with_detect)
    jm = jbaselines.build_baseline(f"baseline/{method}", ep, dp)
    pm = baselines.build_baseline(f"baseline/{method}", ep, dp, device="cpu")
    assert pm.nbits == jm.nbits == nbits and pm.scaling_w == jm.scaling_w
    imgs = np.random.default_rng(1).uniform(0, 1, (3, 72, 96, 3)).astype(np.float32)
    for is_video in (False, True):
        want = jm.embed(imgs, is_video=is_video)
        got = pm.embed(torch.from_numpy(imgs), is_video=is_video)
        np.testing.assert_array_equal(got["msgs"].numpy(), want["msgs"])
        for k in ("imgs_w", "preds_w"):
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL, err_msg=k)
    wp = jm.detect(want["imgs_w"])["preds"]
    gp = pm.detect(got["imgs_w"])["preds"]
    assert gp.shape == (3, nbits + 1)
    np.testing.assert_allclose(gp.numpy(), wp, atol=ATOL)
    if not with_detect:
        assert not gp[:, 0].any()
    sure = np.abs(wp[:, 1:].mean(0)) > ATOL
    np.testing.assert_array_equal(pm.extract_message(got["imgs_w"]).numpy()[:, sure],
                                  jm.extract_message(want["imgs_w"])[:, sure])


def test_baseline_errors(tmp_path):
    """load("baseline/<method>") without its files raises FileNotFoundError,
    an unknown method NotImplementedError, in both packages; a baseline
    runs on the card unless the caller asks for the CPU."""
    for load in (vs.load, lambda n: vt.load(n, device="cpu")):
        with pytest.raises(FileNotFoundError):
            load("baseline/trustmark")
        with pytest.raises(NotImplementedError):
            load("baseline/nope")
    ep, dp, _ = _scripted(tmp_path, "hidden", True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            baselines.build_baseline("baseline/hidden", ep, dp)


# -- utils/layout and utils/image -------------------------------------------------------

def test_layout_both_ways():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(layout.nchw_to_nhwc(x), jlayout.nchw_to_nhwc(x))
    np.testing.assert_array_equal(layout.nchw_to_nhwc(torch.from_numpy(x)).numpy(),
                                  jlayout.nchw_to_nhwc(x))
    y = jlayout.nchw_to_nhwc(x)
    np.testing.assert_array_equal(layout.nhwc_to_nchw(torch.from_numpy(y)).numpy(), x)
    np.testing.assert_array_equal(layout.nhwc_to_nchw(y), jlayout.nhwc_to_nchw(y))


def test_image_utils():
    """median_filter and create_diff_img against the JAX package's; the
    JPEG and WebP round trips equal its (both cv2)."""
    pytest.importorskip("cv2")
    img = np.random.default_rng(2).uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    for k in (3, 5):
        np.testing.assert_allclose(image.median_filter(img, k).numpy(),
                                   np.asarray(jimage.median_filter(jnp.asarray(img), k)),
                                   atol=0)
    np.testing.assert_allclose(image.create_diff_img(img[0], img[1], 4.0),
                               np.asarray(jimage.create_diff_img(img[0], img[1], 4.0)), atol=1e-7)
    for fn, jfn in ((image.jpeg_compress, jimage.jpeg_compress),
                    (image.webp_compress, jimage.webp_compress)):
        np.testing.assert_array_equal(fn(img[0], 60), jfn(img[0], 60))
