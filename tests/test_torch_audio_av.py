"""The port's audio watermark and AV embed against the JAX package's.

* ``SpreadSpectrumAudio`` on the same PCM in both packages: stereo and mono
  music (``test_audio_wm.py``'s synthetic music), another sample rate and
  key, audio shorter than one chip, silence. The watermarked audio within
  1e-6, the detected bits equal and the confidences within 1e-5, on the
  watermarked and on the clean audio.
* ``watermark_audio_file`` and the audio processor without ffmpeg: None
  and the input file, as in the JAX package.
* ``embed_av`` in both packages on one 64x96 h264 clip with a WAV track
  (written with the stdlib ``wave`` module and muxed by the native
  runtime), both models' weights and messages the same: the frames each
  hands to the h264 encode within the NHWC embed tests' u8 tolerance, the
  decoded outputs' frames and an audio stream in both; and the port's route
  without the native runtime (cv2, video only), named in its result.
"""

import inspect
import os
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_audio_wm import _tone_music
from torch_port import NBITS, jax_model, port_model, tiny_card

torch.set_num_threads(2)

F, H, W = 8, 64, 96
# (channels, seconds, sample rate, nbits, key)
AUDIO = {"stereo": (2, 2.0, 48000, 16, 3), "mono": (1, 2.0, 48000, 16, 3),
         "sr16k_8bits": (1, 3.0, 16000, 8, 5), "shorter_than_a_chip": (2, 0.01, 48000, 16, 0),
         "silence": (2, 1.0, 48000, 16, 1)}


def _audio(case: str) -> tuple[np.ndarray, int]:
    ch, sec, sr, _, _ = AUDIO[case]
    if case == "silence":
        return np.zeros((ch, int(sr * sec)), np.float32), sr
    music = _tone_music(sr, sec)
    return (music[0] if ch == 1 else music), sr


@pytest.mark.parametrize("case", list(AUDIO))
def test_spread_spectrum_matches_jax(case):
    from videoseal_tpu.audio_wm import SpreadSpectrumAudio as JaxWM
    from videoseal_tpu_torch.audio_wm import SpreadSpectrumAudio
    _, _, _, nbits, key = AUDIO[case]
    audio, sr = _audio(case)
    jwm, pwm = JaxWM(nbits=nbits, key=key), SpreadSpectrumAudio(nbits=nbits, key=key,
                                                                device="cpu")
    msg = np.random.default_rng(7).integers(0, 2, nbits).astype(np.int32)
    want = jwm.embed(audio, sr, msg)
    got = pwm.embed(audio, sr, msg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == audio.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for x in (want, audio):
        jb, jc = jwm.detect(x, sr)
        pb, pc = pwm.detect(x, sr)
        assert pb.dtype == torch.int32 and np.array_equal(pb.numpy(), jb)
        np.testing.assert_allclose(pc.numpy(), jc, rtol=1e-5, atol=1e-5)
    if case in ("stereo", "mono", "sr16k_8bits"):
        assert np.array_equal(pwm.detect(got, sr)[0].numpy(), msg)


def test_chips_made_once_per_rate():
    from videoseal_tpu.audio_wm import SpreadSpectrumAudio as JaxWM
    from videoseal_tpu_torch.audio_wm import SpreadSpectrumAudio
    wm = SpreadSpectrumAudio(nbits=16, key=3, device="cpu")
    pn = wm._pn(48000)
    assert wm._pn(48000) is pn and wm._pn(16000) is not pn
    np.testing.assert_array_equal(pn.numpy(), JaxWM(nbits=16, key=3)._pn(48000))
    msg = wm.get_random_msg(torch.Generator().manual_seed(0))
    assert msg.dtype == torch.int32 and tuple(msg.shape) == (16,)
    assert torch.equal(msg, wm.get_random_msg(torch.Generator().manual_seed(0)))


def test_audio_file_without_ffmpeg(tmp_path, monkeypatch):
    """No ffmpeg: both packages' watermark_audio_file return None and the
    processors pass the input file through."""
    from videoseal_tpu import audio_wm as jaw
    from videoseal_tpu_torch import audio_wm as paw
    monkeypatch.setattr(jaw.shutil, "which", lambda name: None)
    monkeypatch.setattr(paw.shutil, "which", lambda name: None)
    msg = np.ones(16, np.int32)
    path = str(tmp_path / "x.mkv")
    assert jaw.watermark_audio_file(path, msg) is None
    assert paw.watermark_audio_file(path, msg, device="cpu") is None
    assert paw.make_audio_processor(msg, device="cpu")(path) == path


def test_default_device_is_the_card():
    from videoseal_tpu_torch.audio_wm import SpreadSpectrumAudio
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpreadSpectrumAudio()


# -- embed_av -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def av_clip(tmp_path_factory):
    """An h264 clip with a stereo WAV track, muxed into .mkv (mp4 holds no
    PCM): its path, or a skip without the native runtime."""
    from videoseal_tpu_torch import native
    if not native.available():
        pytest.skip(f"native media runtime not loaded: {native.last_error()}")
    d = tmp_path_factory.mktemp("av")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.stack([np.clip(np.stack([yy * 3 + i * 5, xx * 2, (xx + yy + 7 * i) % 256], -1)
                               + rng.integers(0, 20, (H, W, 3)), 0, 255)
                       for i in range(F)]).astype(np.uint8)
    native.encode_file(str(d / "v.mp4"), frames, codec="h264", crf=18, fps=24)
    sr = 48000
    pcm = (np.clip(_tone_music(sr, F / 24), -1, 1) * 32767).astype(np.int16)
    with wave.open(str(d / "a.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(pcm.T).tobytes())
    path = str(d / "in.mkv")
    assert native.mux_audio(str(d / "v.mp4"), str(d / "a.wav"), path)
    return path


@pytest.fixture(scope="module")
def av_pair():
    card = tiny_card(img_size=64, step=2, chunk=4)
    jm = jax_model(card, seed=41)
    pm = port_model(card, jm)
    msgs = np.random.default_rng(42).integers(0, 2, (1, NBITS)).astype(np.int32)
    jm.get_random_msg = lambda bsz=1, nb_repetitions=1: jnp.asarray(msgs)
    pm.get_random_msg = lambda bsz=1, nb_repetitions=1: torch.from_numpy(msgs).long()
    return jm, pm, msgs


def _has_audio(path: str, tmp: str) -> bool:
    """Does `path` hold an audio stream (the native muxer copies one)?"""
    from videoseal_tpu_torch import native
    return native.mux_audio(path, path, tmp)


def test_embed_av_matches_jax(av_clip, av_pair, tmp_path, monkeypatch):
    """The frames each package hands to the native runtime's h264 encode are
    held at the NHWC embed tests' u8 rule, and the encode's settings
    (codec, crf, fps) must be the same. The encode of the same frames varies
    from process to process (outputs/av_flake/frames_log.txt: equal frames
    in, decoded files up to 17 levels apart), so the decoded outputs are
    held to what does not depend on it: the frame count and shape, the
    audio stream, and a watermark against the source."""
    from videoseal_tpu import native as jax_native
    from videoseal_tpu.inference_av import embed_av as jax_embed_av
    from videoseal_tpu_torch import native
    from videoseal_tpu_torch.inference_av import embed_av
    jm, pm, msgs = av_pair
    encoded, settings = {}, {}
    for tag, mod in (("jax", jax_native), ("port", native)):
        def record(path, frames, *args, real=mod.encode_file, tag=tag, mod=mod, **kw):
            encoded[tag] = mod._to_u8(frames).copy()
            bound = inspect.signature(real).bind(path, frames, *args, **kw)
            bound.apply_defaults()
            settings[tag] = {k: v for k, v in bound.arguments.items()
                             if k not in ("path", "frames")}
            return real(path, frames, *args, **kw)
        monkeypatch.setattr(mod, "encode_file", record)
    jout, pout = str(tmp_path / "j.mkv"), str(tmp_path / "p.mkv")
    jinfo = jax_embed_av(jm, av_clip, jout, chunk_size=4)
    pinfo = embed_av(pm, av_clip, pout, chunk_size=4)
    assert jinfo["frames"] == pinfo["frames"] == F
    assert jinfo["audio"] and pinfo["audio"]
    assert pinfo["route"] == "native" and not pinfo["audio_wm"] and pinfo["audio_note"] is None
    assert np.array_equal(pinfo["msgs"].numpy(), msgs)
    # both encode with the same codec, crf and fps
    assert settings["port"] == settings["jax"], settings
    # the u8 rule of the NHWC embed tests: f32 sums in another order may
    # flip a rounding at .5
    want, got = encoded["jax"], encoded["port"]
    assert got.shape == want.shape == (F, H, W, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 1e-3, (d > 0).mean()
    for p in (jout, pout):
        assert _has_audio(p, str(tmp_path / "probe.mkv"))
    src = native.VideoReader(av_clip).read(F)
    for p in (jout, pout):
        with native.VideoReader(p) as r:
            dec = r.read(F)
        assert dec.shape == (F, H, W, 3)
        assert (dec != src).mean() > 0.1     # watermarked


def test_embed_av_without_native_runtime(av_clip, av_pair, tmp_path, monkeypatch):
    """Without the native runtime the port writes the video alone with cv2
    and its result names the route and why the audio is missing."""
    from videoseal_tpu_torch import native
    from videoseal_tpu_torch.inference_av import embed_av
    _, pm, msgs = av_pair
    monkeypatch.setattr(native, "available", lambda: False)
    out = str(tmp_path / "cv2.mp4")
    info = embed_av(pm, av_clip, out, chunk_size=4)
    assert info["route"] == "cv2" and info["audio"] is False and not info["audio_wm"]
    assert "no native muxer" in info["audio_note"]
    assert info["frames"] == F and os.path.getsize(out) > 0
    assert np.array_equal(info["msgs"].numpy(), msgs)


def test_inference_av_main(av_clip, tmp_path):
    """The CLI on the CPU with --audio_wm 1: without ffmpeg the original
    track is copied, and the line says so."""
    import json

    from videoseal_tpu_torch import inference_av
    card = str(tmp_path / "tiny_card.json")
    with open(card, "w") as f:
        json.dump(tiny_card(img_size=64), f)
    out = str(tmp_path / "out.mkv")
    info = inference_av.main(["--input", av_clip, "--output", out, "--card", card,
                              "--device", "cpu", "--dtype", "float32", "--audio_wm", "1"])
    assert info["frames"] == F and info["audio"]
    assert info["audio_wm"] == bool(inference_av.native.available()
                                    and __import__("shutil").which("ffmpeg"))
