"""The port's robustness evals (videoseal_tpu_torch.evals.{full, step_size_eval,
attacks, vmaf, flops}) against the JAX package's, on the tiny card of
tests/torch_port.py and frames made from a numpy seed: evaluate over the
subset grids (images, and video with the codec rows on the proxy), the
step sweep, the exact codec attacks, VMAF's plumbing, the parameter counts
and the synthetic samples."""

import csv
import os
import stat
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port import LOGIT_ATOL, NBITS, jax_model, port_model, tiny_card

from videoseal_tpu.augmentation import augs as JA
from videoseal_tpu.evals import attacks as JAT
from videoseal_tpu.evals import flops as JFL
from videoseal_tpu.evals import full as JF
from videoseal_tpu.evals import vmaf as JVM
from videoseal_tpu_torch import native
from videoseal_tpu_torch.augmentation import augs as PA
from videoseal_tpu_torch.evals import attacks as PAT
from videoseal_tpu_torch.evals import flops as PFL
from videoseal_tpu_torch.evals import full as PF
from videoseal_tpu_torch.evals import step_size_eval as PSS
from videoseal_tpu_torch.evals import vmaf as PVM

torch.set_num_threads(1)

# psnr, ssim and linf of the embed: the same float32 embed up to sum orders
QUALITY_ATOL = 1e-4
# one shape for images and video: the JAX side compiles its detect once a shape
IMG_SHAPE = VID_SHAPE = (4, 64, 96, 3)


def _grid(mod, is_video):
    """The subset grid, its codec row on the proxy."""
    last = mod.VideoCompressionProxy(codec="h264") if is_video else mod.JPEG()
    return [(mod.Identity(), [0]), (mod.Crop(), [0.71]), (mod.Brightness(), [1.5]),
            (last, [30] if is_video else [60])]


@pytest.fixture(scope="module")
def pair():
    """The tiny card in both packages, the same weights, the same fixed
    messages, and each model's detect logits recorded."""
    card = tiny_card(img_size=64)
    jm = jax_model(card, seed=41)
    pm = port_model(card, jm)
    msgs = np.random.default_rng(42).integers(0, 2, (4, NBITS)).astype(np.int32)
    jm.get_random_msg = lambda bsz=1, nb_repetitions=1: jnp.asarray(msgs[:bsz])
    pm.get_random_msg = lambda bsz=1, nb_repetitions=1: torch.from_numpy(msgs[:bsz]).long()
    for m, conv in ((jm, np.asarray), (pm, lambda t: t.numpy())):
        m.logits = []
        detect = m.detect

        def recorded(imgs, is_video=False, _detect=detect, _m=m, _conv=conv):
            out = _detect(imgs, is_video=is_video)
            _m.logits.append(_conv(out["preds"]))
            return out

        m.detect = recorded
    return jm, pm


def _decoded(logits, is_video):
    bits = logits[:, 1:]
    return bits.mean(axis=0, keepdims=True) if is_video else bits


@pytest.mark.parametrize("is_video", [False, True])
def test_evaluate_matches_jax(pair, is_video, tmp_path):
    """The same rows in the same order, JAX's columns all present (the port
    adds attack_time and timer); psnr, ssim and linf within QUALITY_ATOL;
    the logits within LOGIT_ATOL (K2's plain version rounds to bf16 inside,
    as the TPU kernel does, where JAX's CPU extractor is all f32); bit_acc
    equal but for the bits whose JAX logit (or, for video, frame-mean
    logit) lies within LOGIT_ATOL of 0."""
    jm, pm = pair
    samples = list(JF.synthetic_samples(1, VID_SHAPE if is_video else IMG_SHAPE, seed=7))
    jm.logits.clear()
    pm.logits.clear()
    want = JF.evaluate(jm, samples, is_video=is_video, validation_augs=_grid(JA, is_video),
                       verbose=False)
    out_csv = str(tmp_path / "metrics.csv")
    got = PF.evaluate(pm, samples, is_video=is_video, validation_augs=_grid(PA, is_video),
                      verbose=False, out_csv=out_csv)
    assert [(r["sample"], r["aug"], r["strength"]) for r in got] == \
           [(r["sample"], r["aug"], r["strength"]) for r in want]
    for g, w, jl, pl in zip(got, want, jm.logits, pm.logits):
        assert list(g)[:len(w)] == list(w) and list(g)[len(w):] == ["attack_time", "timer"]
        assert g["timer"] == "host_clock" and g["attack_time"] >= 0
        for k in ("psnr", "ssim", "linf"):
            assert abs(g[k] - w[k]) <= QUALITY_ATOL, (k, g[k], w[k])
        assert np.isnan(g["lpips"]) and np.isnan(g["msssim"])
        np.testing.assert_allclose(pl, jl, atol=LOGIT_ATOL)
        dj = _decoded(jl, is_video)
        unsure = (np.abs(dj) <= LOGIT_ATOL).sum() / dj.size
        assert abs(g["bit_acc"] - w["bit_acc"]) <= unsure, (g["aug"], g["bit_acc"], w["bit_acc"])
        if g["bit_acc"] == w["bit_acc"]:
            # the p-value in float64 (scipy); the capacity in float32, where
            # 1 - entropy cancels near an accuracy of 0.5
            for k in ("pvalue", "log10_pvalue"):
                assert g[k] == pytest.approx(w[k], rel=1e-9)
            assert g["capacity"] == pytest.approx(w["capacity"], rel=1e-4, abs=1e-6)
    with open(out_csv) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4 and rows[0]["aug"] == "Identity()" and rows[0]["lpips"] == ""
    assert float(rows[1]["psnr"]) == got[1]["psnr"]


class _Stub:
    """A model whose detect gives pixelwise logits: the localization
    columns of evaluate."""

    def __init__(self, xp, device=None):
        self.xp, self.nbits, self.device = xp, 8, device
        self.msgs = np.random.default_rng(0).integers(0, 2, (4, 8)).astype(np.int32)

    def embed(self, imgs, is_video=False):
        return {"imgs_w": imgs * 0.98 + 0.01, "msgs": self.xp(self.msgs[:imgs.shape[0]])}

    def detect(self, imgs, is_video=False):
        x = np.asarray(imgs)[:, ::8, ::8, :1]
        preds = np.concatenate([x - 0.5] + [np.sin(7 * x + i) for i in range(8)], -1)
        return {"preds": self.xp(preds.astype(np.float32))}


def test_localization_columns_match_jax():
    samples = list(JF.synthetic_samples(1, IMG_SHAPE, seed=8))
    grid = lambda mod: [(mod.Identity(), [0]), (mod.Brightness(), [0.5])]  # noqa: E731
    want = JF.evaluate(_Stub(jnp.asarray), samples, validation_augs=grid(JA), verbose=False)
    got = PF.evaluate(_Stub(torch.as_tensor, torch.device("cpu")), samples,
                      validation_augs=grid(PA), verbose=False)
    for g, w in zip(got, want):
        for k in ("iou1", "acc", "bit_acc_1msg", "bit_acc", "psnr"):
            assert g[k] == pytest.approx(w[k], abs=1e-5), k


def test_step_sweep_matches_jax(pair, tmp_path):
    """The sweep's per-step PSNR against the JAX package's evaluate of its
    model rebuilt with that step (as its step_size_eval does)."""
    import dataclasses
    from videoseal_tpu.augmentation.validation import get_validation_augs_subset
    from videoseal_tpu.models.videoseal import VideoSeal as JVS

    jm, pm = pair
    shape, cfg = (4, 64, 96, 3), pm.cfg
    try:
        rows = PSS.sweep(lambda: pm, [1, 2], 1, str(tmp_path), shape)
    finally:
        pm.cfg = cfg
    assert [r["step_size"] for r in rows] == [1, 2]
    with open(tmp_path / "summary.csv") as f:
        assert [int(r["step_size"]) for r in csv.DictReader(f)] == [1, 2]
    assert (tmp_path / "metrics_step1.csv").exists()
    for step, row in zip((1, 2), rows):
        j = JVS(jm.embedder_spec, jm.extractor_spec, jm.embedder_vars, jm.extractor_vars,
                jm.attenuation, dataclasses.replace(jm.cfg, step_size=step),
                scaling_w=jm.scaling_w, scaling_i=jm.scaling_i, card=jm.card)
        j.get_random_msg = jm.get_random_msg
        want = JF.evaluate(j, JF.synthetic_samples(1, shape), is_video=True,
                           validation_augs=get_validation_augs_subset(True)[:1], verbose=False)
        assert abs(row["psnr"] - want[0]["psnr"]) <= QUALITY_ATOL


@pytest.mark.parametrize("n,shape,seed", [(2, (4, 64, 96, 3), 0), (1, (3, 40, 48, 3), 5)])
def test_synthetic_samples_bit_equal(n, shape, seed):
    got = list(PF.synthetic_samples(n, shape, seed))
    want = list(JF.synthetic_samples(n, shape, seed))
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_param_counts_match_jax(pair):
    jm, pm = pair
    assert PFL.count_params(pm.embedder) == JFL._count_params(jm.embedder_vars)
    assert PFL.count_params(pm.extractor) == JFL._count_params(jm.extractor_vars)
    row = PFL.cost_analysis(pm, (2, 64, 64, 3))
    assert row["counter"] == PFL.COUNTER and row["embed_gflops"] > 0 and row["extract_gflops"] > 0
    assert row["embedder_params_M"] == round(JFL._count_params(jm.embedder_vars) / 1e6, 3)


# -- the exact codecs and VMAF ---------------------------------------------------------

@pytest.mark.parametrize("fn,q", [("jpeg_exact", 50), ("webp_exact", 70)])
def test_image_codecs_bit_equal(fn, q):
    pytest.importorskip("cv2")
    x = next(PF.synthetic_samples(1, (2, 48, 64, 3), seed=2))
    np.testing.assert_array_equal(getattr(PAT, fn)(x, q), getattr(JAT, fn)(x, q))
    np.testing.assert_array_equal(getattr(PAT, fn)(x[0], q), getattr(JAT, fn)(x[0], q))


@pytest.mark.parametrize("codec,crf", [("h264", 30), ("h265", 40), ("mpeg4", None)])
def test_video_codec_exact_bit_equal(codec, crf):
    """Both packages' round trips through the same native library. 64x96:
    at some small sizes (48x64, 96x96, 128x96) the library's output varies
    from call to call (ROADMAP §3), at this one it does not."""
    pytest.importorskip("cv2")
    x = next(PF.synthetic_samples(1, (4, 64, 96, 3), seed=3))
    np.testing.assert_array_equal(PAT.video_codec_exact(x, codec, crf=crf),
                                  JAT.video_codec_exact(x, codec, crf=crf))
    assert PAT.available_video_codecs() == JAT.available_video_codecs()


def test_vmaf_plumbing_matches_jax(tmp_path, monkeypatch):
    """No ffmpeg with libvmaf: both find none and score None, with the same
    file sizes; a stand-in ffmpeg that lists libvmaf and prints a score:
    both parse the same score."""
    if not native.available():
        pytest.skip("the native media runtime does not load here")
    frames = next(PF.synthetic_samples(1, (6, 64, 96, 3), seed=4))
    for mod in (PVM, JVM):
        mod.find_ffmpeg.cache_clear()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("VSM_FFMPEG", raising=False)
    try:
        assert PVM.find_ffmpeg() is None and not PVM.vmaf_available()
        got = PVM.vmaf_on_tensor(frames, return_aux=True, crf=28)
        want = JVM.vmaf_on_tensor(frames, return_aux=True, crf=28)
        assert got == want and got[0] is None
        fake = tmp_path / "ffmpeg"
        fake.write_text("#!/bin/sh\nif [ \"$2\" = -filters ]; then echo ' libvmaf  VV->V';"
                        " else echo 'VMAF score: 87.25' >&2; fi\n")
        fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("VSM_FFMPEG", str(fake))
        for mod in (PVM, JVM):
            mod.find_ffmpeg.cache_clear()
        assert PVM.find_ffmpeg() == JVM.find_ffmpeg() == str(fake)
        assert PVM.vmaf_on_tensor(frames, frames) == JVM.vmaf_on_tensor(frames, frames) == 87.25
    finally:
        for mod in (PVM, JVM):
            mod.find_ffmpeg.cache_clear()


def test_main_on_cpu(tmp_path, capsys):
    """The CLI with --device cpu on a tiny checkpoint (its card rebuilt from
    the file's args): the identity row over one sample of 4 synthetic
    images, metrics.csv written."""
    import videoseal_tpu_torch as vt
    from torch_port import tiny_preset_card

    card, args = tiny_preset_card()
    ckpt = str(tmp_path / "m.npz")
    vt.save_npz(ckpt, vt.VideoSeal.from_card(card, device="cpu"), args=args)
    rows = PF.main(["--card", ckpt, "--device", "cpu", "--only_identity", "1",
                    "--num_samples", "1", "--output_dir", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["aug"] == "Identity()" and rows[0]["timer"] == "host_clock"
    assert np.isfinite(rows[0]["psnr"]) and 0 <= rows[0]["bit_acc"] <= 1
    assert os.path.exists(tmp_path / "metrics.csv")
    assert "LPIPS column skipped" in capsys.readouterr().out
    assert sys.modules["videoseal_tpu_torch.evals.full"] is PF
