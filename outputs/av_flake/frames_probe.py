"""Where test_embed_av_matches_jax's variance comes from: one run of its
set-up (the same clip, tiny card, weights and message) that records the u8
frames each package's embed_av hands to ``native.encode_file``, and prints
one JSON line:

  pre_max, pre_share   the two packages' pre-encode frames: largest |diff|
                       and the share of values that differ (the test's u8
                       rule: max <= 1, share < 1e-3);
  dec_max, dec_share   the same for the two decoded output files;
  again_max            the port's pre-encode frames encoded twice more by
                       the same call, both files decoded: largest |diff|
                       between the two (the encoder against itself).

Run from the repository's root, each run in a fresh process:

  outputs/av_flake/frames.sh [N=20] > outputs/av_flake/frames_log.txt
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import wave

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import conftest  # noqa: E402,F401  (pins JAX to the CPU, as the tests do)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_audio_wm import _tone_music  # noqa: E402
from test_torch_audio_av import F, H, W  # noqa: E402
from torch_port import NBITS, jax_model, port_model, tiny_card  # noqa: E402

from videoseal_tpu import native as jnative  # noqa: E402
from videoseal_tpu.inference_av import embed_av as jax_embed_av  # noqa: E402
from videoseal_tpu_torch import native  # noqa: E402
from videoseal_tpu_torch.inference_av import embed_av  # noqa: E402

torch.set_num_threads(2)


def _clip(d: str) -> str:
    """test_torch_audio_av.av_clip's clip."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.stack([np.clip(np.stack([yy * 3 + i * 5, xx * 2, (xx + yy + 7 * i) % 256], -1)
                               + rng.integers(0, 20, (H, W, 3)), 0, 255)
                       for i in range(F)]).astype(np.uint8)
    native.encode_file(os.path.join(d, "v.mp4"), frames, codec="h264", crf=18, fps=24)
    sr = 48000
    pcm = (np.clip(_tone_music(sr, F / 24), -1, 1) * 32767).astype(np.int16)
    with wave.open(os.path.join(d, "a.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(pcm.T).tobytes())
    path = os.path.join(d, "in.mkv")
    assert native.mux_audio(os.path.join(d, "v.mp4"), os.path.join(d, "a.wav"), path)
    return path


def _diff(a: np.ndarray, b: np.ndarray) -> tuple[int, float]:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def main() -> None:
    card = tiny_card(img_size=64, step=2, chunk=4)
    jm = jax_model(card, seed=41)
    pm = port_model(card, jm)
    msgs = np.random.default_rng(42).integers(0, 2, (1, NBITS)).astype(np.int32)
    jm.get_random_msg = lambda bsz=1, nb_repetitions=1: jnp.asarray(msgs)
    pm.get_random_msg = lambda bsz=1, nb_repetitions=1: torch.from_numpy(msgs).long()
    seen = {}
    for tag, mod in (("jax", jnative), ("port", native)):
        def rec(path, frames, *a, real=mod.encode_file, tag=tag, mod=mod, **kw):
            seen[tag] = mod._to_u8(frames).copy()
            return real(path, frames, *a, **kw)
        mod.encode_file = rec
    with tempfile.TemporaryDirectory() as d:
        clip = _clip(d)
        jout, pout = os.path.join(d, "j.mkv"), os.path.join(d, "p.mkv")
        jax_embed_av(jm, clip, jout, chunk_size=4)
        embed_av(pm, clip, pout, chunk_size=4)
        with native.VideoReader(jout) as rj, native.VideoReader(pout) as rp:
            want, got = rj.read(F), rp.read(F)
        again = []
        for i in range(2):
            p = os.path.join(d, f"again{i}.mp4")
            native.encode_file(p, seen["port"], codec="h264", crf=18, fps=24)
            with native.VideoReader(p) as r:
                again.append(r.read(F))
    pre, dec = _diff(seen["port"], seen["jax"]), _diff(got, want)
    print(json.dumps({"pre_max": pre[0], "pre_share": pre[1], "dec_max": dec[0],
                      "dec_share": dec[1], "again_max": _diff(*again)[0]}), flush=True)


if __name__ == "__main__":
    main()
