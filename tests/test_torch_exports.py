"""The JAX package's public names in the port: every package-level export
of ``videoseal_tpu``'s ``__init__`` files imports from the same package of
``videoseal_tpu_torch`` (less the JAX sharding specs ``replicated`` and
``batch_sharding``), and the functions that had no port are held against
the JAX ones on the same inputs: ``yuv_to_rgb`` and the resizes within
float32 rounding, ``upsample_nearest`` and ``CONVNEXT_PRESETS`` exactly,
``save_vid``/``get_fps`` through a file each package writes and the other
reads.
"""

import importlib

import numpy as np
import pytest
import torch

# package -> the names its __init__ exports in both packages
EXPORTS = {
    "": ["load", "setup_model_from_model_card"],
    "models": ["VideoSeal", "build_embedder", "build_extractor"],
    "losses": ["build_perceptual_loss", "PerceptualLoss", "VideoSealLoss"],
    "parallel": ["make_mesh", "TrainerModules", "TrainState", "create_train_state",
                 "make_train_step"],
    "ops": ["rgb_to_yuv", "yuv_to_rgb", "rgb_to_y", "resize_bilinear", "resize_to"],
    "kernels": ["fused_jnd_blend", "supports_fused_blend"],
}
# float32 multiply-adds and matmuls in another order
F32_ATOL = 1e-6


def _mod(pkg: str, sub: str):
    return importlib.import_module(pkg + ("." + sub if sub else ""))


@pytest.mark.parametrize("sub", sorted(EXPORTS))
def test_package_exports(sub):
    """Each name imports from the port's package, is what the port's module
    defines under that name, and the JAX package exports it too (the list
    is the JAX __init__'s, less its sharding specs)."""
    port, jax_pkg = _mod("videoseal_tpu_torch", sub), _mod("videoseal_tpu", sub)
    for name in EXPORTS[sub]:
        assert hasattr(jax_pkg, name), name
        assert name in port.__all__ and getattr(port, name) is not None, name
    if sub == "parallel":
        jax_names = {n for n in vars(jax_pkg) if not n.startswith("_")
                     and not isinstance(vars(jax_pkg)[n], type(importlib))}
        assert jax_names - set(EXPORTS[sub]) == {"replicated", "batch_sharding"}


@pytest.mark.parametrize("shape", [(3,), (2, 5, 7, 3), (4, 16, 16, 3)])
def test_yuv_to_rgb_matches_jax(shape):
    from videoseal_tpu.ops import yuv_to_rgb as jax_yuv_to_rgb
    from videoseal_tpu_torch.ops import rgb_to_yuv, yuv_to_rgb
    x = np.random.default_rng(0).uniform(-0.6, 1.0, shape).astype(np.float32)
    got = yuv_to_rgb(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_yuv_to_rgb(x)), rtol=0, atol=F32_ATOL)
    # the inverse of rgb_to_yuv up to the constants' five digits
    rgb = torch.as_tensor(np.abs(x))
    assert float((yuv_to_rgb(rgb_to_yuv(rgb)) - rgb).abs().max()) < 1e-4


@pytest.mark.parametrize("size,antialias", [(32, True), ((24, 40), True), ((96, 72), False),
                                            (17, True)])
def test_resize_to_matches_jax(size, antialias):
    from videoseal_tpu.ops import resize_to as jax_resize_to
    from videoseal_tpu_torch.ops import resize_to
    x = np.random.default_rng(1).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    got = resize_to(torch.as_tensor(x), size, antialias=antialias).numpy()
    want = np.asarray(jax_resize_to(x, size, antialias=antialias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("factor,dtype", [(1, np.float32), (2, np.float32), (3, np.uint8)])
def test_upsample_nearest_matches_jax(factor, dtype):
    from videoseal_tpu.ops.resize import upsample_nearest as jax_up
    from videoseal_tpu_torch.ops.resize import upsample_nearest
    x = (np.random.default_rng(2).uniform(0, 255, (2, 5, 7, 3))).astype(dtype)
    got = upsample_nearest(torch.as_tensor(x), factor).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_up(x, factor)))


def test_convnext_presets_equal_jax():
    from videoseal_tpu.modules.convnext import CONVNEXT_PRESETS as JAX_PRESETS
    from videoseal_tpu_torch.modules.convnext import CONVNEXT_PRESETS
    assert CONVNEXT_PRESETS == JAX_PRESETS
    # the tiny preset is the extractor's convnext_tiny encoder
    from videoseal_tpu_torch import presets
    enc = presets.EXTRACTOR["convnext_tiny"]["encoder"]
    assert list(CONVNEXT_PRESETS["tiny"]["depths"]) == list(enc["depths"])
    assert list(CONVNEXT_PRESETS["tiny"]["dims"]) == list(enc["dims"])


@pytest.mark.parametrize("fps", [24.0, 12.0])
def test_save_vid_get_fps_round_trip(tmp_path, fps):
    """Each package's save_vid writes a clip the other's get_fps reads at
    its frame rate; the two files decode to the same frames (cv2's mp4v on
    the same u8 frames)."""
    cv2 = pytest.importorskip("cv2")
    from videoseal_tpu.utils import display as jd
    from videoseal_tpu_torch.utils import display as pd
    frames = np.random.default_rng(3).uniform(0, 1, (6, 48, 64, 3)).astype(np.float32)
    paths = {"port": str(tmp_path / "port.mp4"), "jax": str(tmp_path / "jax.mp4")}
    pd.save_vid(frames, paths["port"], fps=fps)
    jd.save_vid(frames, paths["jax"], fps=fps)
    assert jd.get_fps(paths["port"]) == pd.get_fps(paths["jax"]) == pytest.approx(fps)

    def decode(path):
        cap, out = cv2.VideoCapture(path), []
        ok, fr = cap.read()
        while ok:
            out.append(fr)
            ok, fr = cap.read()
        cap.release()
        return np.stack(out)

    port, jax_clip = decode(paths["port"]), decode(paths["jax"])
    assert port.shape == (6, 48, 64, 3)
    np.testing.assert_array_equal(port, jax_clip)
    # a file cv2 cannot open reads as in the JAX package
    missing = str(tmp_path / "missing.mp4")
    assert pd.get_fps(missing) == jd.get_fps(missing)
