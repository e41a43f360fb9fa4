"""Streaming on the port (videoseal_tpu_torch.native, .inference_streaming,
.evals) against the JAX package: the native readers bit for bit, the
planar streaming embed and the detect over video files, the stream engine
on in-memory chunks, and the evals' outputs.

The tests that read or write video files need the native media runtime and
skip where neither the committed library nor a build of native/media.cpp
loads. The JAX side runs its Pallas blend in interpret mode."""

import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port import LOGIT_ATOL, NBITS, jax_model, port_model, tiny_card, tiny_preset_card

import videoseal_tpu_torch as vt
from videoseal_tpu import inference_streaming as jstream
from videoseal_tpu import native as jnative
from videoseal_tpu.models.videoseal import embed_pipeline_planar as jax_embed_planar
from videoseal_tpu_torch import inference_streaming as pstream
from videoseal_tpu_torch import native as pnative
from videoseal_tpu_torch.evals import lowres_quality, streaming_bench
from videoseal_tpu_torch.evals import speed as speed_mod
from videoseal_tpu_torch.kernels import fused_planar

torch.set_num_threads(1)

# the native readers' widths must be multiples of 16 (native.VideoReader)
F, H, W, CHUNK = 12, 128, 192, 5


@pytest.fixture
def media():
    if not (pnative.available() and jnative.available()):
        pytest.skip(f"native media runtime not loaded: {pnative.last_error()}")
    return pnative


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A synthetic h264 clip, F frames of H x W (None without the runtime)."""
    if not pnative.available():
        return None
    path = str(tmp_path_factory.mktemp("clip") / "src.mp4")
    streaming_bench.synth_video(path, F, H, W)
    return path


@pytest.fixture(scope="module")
def pair():
    """A tiny planar card in both packages with the same weights and one
    fixed message; the JAX model's embed_planar runs its kernel interpreted."""
    card = tiny_card(img_size=128, step=2, chunk=4)
    jm = jax_model(card, seed=31)
    pm = port_model(card, jm)
    msgs = np.random.default_rng(32).integers(0, 2, (1, NBITS)).astype(np.int32)
    jm.get_random_msg = lambda bsz=1, nb_repetitions=1: jnp.asarray(msgs)
    pm.get_random_msg = lambda bsz=1, nb_repetitions=1: torch.from_numpy(msgs).long()

    def embed_planar(imgs_p, h, w, msgs=None, lowres_attenuation=None):
        imgs_w = jax_embed_planar(jm.embedder_spec.module, jm.attenuation, jm.cfg,
                                  jm.embedder_vars, jnp.asarray(imgs_p), jnp.asarray(msgs),
                                  jnp.float32(jm.scaling_w), jnp.float32(jm.scaling_i), h, w,
                                  interpret=True, lowres_attenuation=lowres_attenuation)
        return {"imgs_w": imgs_w, "msgs": msgs}

    jm.embed_planar = embed_planar
    return jm, pm, msgs


def _decode(path, n=64):
    with pnative.VideoReader(path) as r:
        return r.read(n)


# -- the native bindings ------------------------------------------------------------

@pytest.mark.parametrize("planar", [False, True])
def test_reader_matches_jax(media, clip, planar):
    """The port's reader and the JAX package's, on the same library: the
    same frames bit for bit, in chunks that leave a partial last one."""
    a, b = pnative.VideoReader(clip), jnative.VideoReader(clip)
    assert (a.width, a.height, a.fps, a.nframes) == (b.width, b.height, b.fps, b.nframes)
    got = []
    while True:
        x = a.read_planar(CHUNK) if planar else a.read(CHUNK)
        y = b.read_planar(CHUNK) if planar else b.read(CHUNK)
        assert x.shape == y.shape and np.array_equal(x, y)
        if x.shape[0] == 0:
            break
        got.append(x.shape[0])
    a.close()
    b.close()
    assert got == [5, 5, 2]


def test_reader_into_reused_buffer(media, clip):
    """read_planar into a caller's buffer equals a fresh read; the pad stays 0."""
    buf = np.zeros(fused_planar.planar_shape(CHUNK, H, W), np.uint8)
    with pnative.VideoReader(clip) as a, pnative.VideoReader(clip) as b:
        for _ in range(3):
            x = a.read_planar(CHUNK, out=buf)
            y = b.read_planar(CHUNK)
            assert np.array_equal(x, y)
    r0, c0 = fused_planar.R0, fused_planar.C0
    assert not buf[:, :, :r0].any() and not buf[:, :, :, :c0].any()
    assert not buf[:, :, r0 + H:].any() and not buf[:, :, :, c0 + W:].any()
    with pytest.raises(ValueError):
        pnative.VideoReader(clip).read(CHUNK, out=np.zeros((CHUNK, H, W + 1, 3), np.uint8))


def test_reader_refuses_unsafe_width(media, tmp_path):
    """At a width that is not a multiple of 16 the native reader's RGB
    conversion writes past its buffers; the port refuses such a file."""
    path = str(tmp_path / "w200.mp4")
    pnative.encode_file(path, np.zeros((2, 64, 200, 3), np.uint8))
    with pytest.raises(ValueError, match="multiple of 16"):
        pnative.VideoReader(path)


def test_loader_reports_build_failure(tmp_path):
    """Neither the committed library nor a build loads: unavailable, with
    g++'s first error line and the committed library's error; nothing is
    written beside the source."""
    src = tmp_path / "media.cpp"
    src.write_text("this is not C++\n")
    rt = pnative._Runtime(committed=str(tmp_path / "missing.so"), src=str(src),
                          build_root=str(tmp_path / "build"))
    assert rt.load() is None and rt.origin is None
    assert "g++" in rt.error and "missing.so" in rt.error
    assert sorted(os.listdir(tmp_path)) == ["build", "media.cpp"]


def test_loader_prefers_the_committed_library(media):
    assert pnative.origin() == pnative._COMMITTED
    assert pnative.codec_available("h264")


# -- streaming against the JAX package ----------------------------------------------

def test_embed_video_planar_matches_jax(media, clip, pair, tmp_path):
    """embed_video_planar of both packages on the same clip, message and
    weights: the same frame count, and the two outputs, decoded, within the
    encoder's reach of each other. The planar frames agree within 1 LSB on
    < 1e-3 of pixels (test_torch_pipeline); libx264 at crf 18 may turn a
    one-LSB input difference into a few LSB in its block."""
    jm, pm, msgs = pair
    jdst, pdst = str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")
    j = jstream.embed_video_planar(jm, clip, jdst, chunk_size=CHUNK)
    t = pstream.embed_video_planar(pm, clip, pdst, chunk_size=CHUNK)
    assert j["frames"] == t["frames"] == t["stats"]["frames"] == F
    assert t["stats"]["chunks"] == 3
    assert np.array_equal(t["msgs"].numpy(), msgs)
    a, b = _decode(jdst), _decode(pdst)
    assert a.shape == b.shape == (F, H, W, 3)
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert d.mean() < 0.01 and d.max() <= 4, (d.mean(), d.max())   # measured: identical
    src = _decode(clip)
    assert (b != src).mean() > 0.1   # the watermark changed the frames


def test_detect_video_matches_jax(media, clip, pair, tmp_path):
    """detect_video's logits against the JAX model's detect on the same
    frames (the port's reader, / 255), within LOGIT_ATOL; its message against
    the JAX package's detect_video (cv2 decodes there) where the averaged
    logit clears the tolerance."""
    jm, pm, _ = pair
    dst = str(tmp_path / "wm.mp4")
    pstream.embed_video_planar(pm, clip, dst, chunk_size=CHUNK)
    msg, logits = pstream.detect_video(pm, dst, chunk_size=CHUNK, return_preds=True)
    frames = _decode(dst).astype(np.float32) / 255.0
    want = np.asarray(jm.detect(frames)["preds"])
    assert logits.shape == want.shape == (F, 1 + NBITS)
    np.testing.assert_allclose(logits.numpy(), want, atol=LOGIT_ATOL)
    jmsg = np.asarray(jstream.detect_video(jm, dst, chunk_size=CHUNK))
    sure = np.abs(want[:, 1:].mean(0)) > 2 * LOGIT_ATOL
    assert msg.shape == (1, NBITS) and sure.sum() > NBITS // 2
    assert np.array_equal(msg.numpy()[0][sure], jmsg[0][sure])


def test_nhwc_stream_matches_jax():
    """The NHWC embed's device work (u8 -> / 255 -> embed -> clip(x * 255 +
    0.5)), through the engine on in-memory chunks, against the JAX model's
    embed of the same float frames with the JAX streaming writer's
    rounding: within 1 LSB on < 1e-3 of pixels (K6's plain version sums in
    another order)."""
    card = tiny_card(img_size=64, step=2, chunk=4, out_channels=3)
    jm = jax_model(card, seed=33)
    pm = port_model(card, jm)
    assert not pm.supports_planar
    rng = np.random.default_rng(34)
    frames = rng.integers(0, 256, (7, 72, 96, 3), np.uint8)
    msgs = rng.integers(0, 2, (1, NBITS)).astype(np.int32)
    out = []
    stats = pstream.run_stream(_fill_from(frames), (3, 72, 96, 3),
                               pstream.embed_step(pm, torch.from_numpy(msgs).long()),
                               lambda a: out.append(a.copy()), "cpu")
    got = np.concatenate(out)
    assert stats["frames"] == 7 and stats["chunks"] == 3
    want = []
    for i in range(0, 7, 3):
        y = np.asarray(jm.embed(frames[i:i + 3].astype(np.float32) / 255.0,
                                msgs=jnp.asarray(msgs), is_video=True)["imgs_w"])
        want.append(np.clip(y * 255.0 + 0.5, 0, 255).astype(np.uint8))
    d = np.abs(got.astype(np.int16) - np.concatenate(want).astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_embed_video_nhwc_file(media, clip, tmp_path):
    """A card without the planar path streams NHWC frames through its file
    route: every frame, and an output near the source."""
    card = tiny_card(img_size=64, step=2, chunk=4, out_channels=3)
    pm = vt.VideoSeal.from_card(card, device="cpu", seed=3)
    dst = str(tmp_path / "rgb.mp4")
    info = pstream.embed_video(pm, clip, dst, chunk_size=CHUNK)
    assert info["frames"] == F and info["stats"]["chunks"] == 3
    out, src = _decode(dst), _decode(clip)
    assert out.shape == src.shape
    mse = ((out.astype(np.float64) - src) ** 2).mean()
    assert 0 < mse < 400, mse


def test_cli_on_cpu(media, clip, tmp_path, capsys):
    """python -m videoseal_tpu_torch.inference_streaming on the CPU, the model
    loaded by path from a checkpoint whose args name the smallest presets."""
    card, args = tiny_preset_card()
    ckpt = str(tmp_path / "tiny.npz")
    vt.save_npz(ckpt, vt.VideoSeal.from_card(card, device="cpu", seed=5), args=args)
    dst = str(tmp_path / "cli.mp4")
    pstream.main(["--input", clip, "--output", dst, "--card", ckpt, "--device", "cpu",
                  "--chunk_size", str(CHUNK)])
    printed = capsys.readouterr().out
    assert f"embedded {F} frames -> {dst}" in printed and "bit accuracy" in printed
    assert _decode(dst).shape == (F, H, W, 3)


# -- the stream engine -----------------------------------------------------------------

def _fill_from(frames):
    pos = [0]

    def fill(buf):
        n = min(buf.shape[0], frames.shape[0] - pos[0])
        buf[:n] = frames[pos[0]:pos[0] + n]
        pos[0] += n
        return n
    return fill


def test_engine_on_memory_chunks():
    """Every chunk in order through reused buffers, a partial last chunk,
    the step's output of another shape and dtype."""
    frames = np.random.default_rng(40).integers(0, 256, (11, 6, 8, 3), np.uint8)
    out = []
    stats = pstream.run_stream(_fill_from(frames), (4, 6, 8, 3),
                               lambda x: x.float().mean(dim=(1, 2)) + 1.0,
                               lambda a: out.append(a.copy()), "cpu")
    assert stats["frames"] == 11 and stats["chunks"] == 3 and stats["wall_s"] > 0
    got = np.concatenate(out)
    np.testing.assert_allclose(got, frames.astype(np.float32).mean(axis=(1, 2)) + 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("where", ["fill", "step", "sink"])
def test_engine_failure_raises_and_stops(where):
    """A failure on any of the three threads reaches the caller, and no
    worker thread outlives the call."""
    frames = np.zeros((20, 4, 4, 3), np.uint8)
    fill = _fill_from(frames)
    calls = {"fill": 0, "step": 0, "sink": 0}

    def boom(name):
        calls[name] += 1
        if name == where and calls[name] == 2:
            raise RuntimeError(f"{name} failed")

    def f(buf):
        boom("fill")
        return fill(buf)

    def s(x):
        boom("step")
        return x

    before = threading.active_count()
    with pytest.raises(Exception) as info:
        pstream.run_stream(f, (3, 4, 4, 3), s, lambda a: boom("sink"), "cpu")
    err = info.value
    while err is not None and f"{where} failed" not in str(err):
        err = err.__cause__
    assert err is not None, info.value
    assert threading.active_count() == before


def test_stub_device_overlaps(media):
    """streaming_bench with the device stubbed by a sleep: the stream's wall
    tracks the slowest stage, not the sum of the three."""
    res = streaming_bench.main(["--height", str(H), "--width", str(W), "--frames", "24",
                                "--chunk", "8", "--stub_device_fps", "150"])
    assert res["frames"] == 24 and res["device"] == "stub"
    for k in ("decode_fps", "encode_fps", "stream_fps", "overlap_ratio", "device_fps"):
        assert res[k] > 0, k
    assert res["stream_vs_slowest_stage"] < 2.0


# -- the evals -----------------------------------------------------------------------

def test_lowres_quality_rows():
    rows = lowres_quality.run("videoseal_1.0", 64, 96, 2, 0, device="cpu")
    assert [r["mode"] for r in rows] == ["fullres_jnd", "lowres_attenuation",
                                         "delta_lowres_vs_fullres"]
    for r in rows[:2]:
        assert np.isfinite(r["psnr"]) and r["psnr"] > 20
        assert np.isfinite(r["ssim"]) and 0 < r["ssim"] <= 1.001
        assert 0 < r["linf_u8"] <= 255
        assert 0 <= r["bit_acc_per_frame"] <= 1 and 0 <= r["bit_acc_pooled"] <= 1
    assert rows[2]["max_u8"] >= 0 and np.isfinite(rows[2]["psnr_delta"])


def test_speed_rows(tmp_path):
    model = vt.VideoSeal.from_card(tiny_card(img_size=64), device="cpu")
    frames = np.random.default_rng(41).uniform(0, 1, (4, 64, 96, 3)).astype(np.float32)
    res = speed_mod.test_speed(model, frames, num_runs=1, trace_dir=str(tmp_path))
    assert res["device"] == "cpu" and res["frames"] == 4
    for k in ("embed_ms_per_frame", "extract_ms_per_frame", "embed_fps", "extract_fps"):
        assert res[k] > 0, k
    assert os.path.getsize(tmp_path / "speed_trace.json") > 0
