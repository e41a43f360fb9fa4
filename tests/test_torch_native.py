"""The port's exact codec round trip (videoseal_tpu_torch.native.video_roundtrip)
refuses widths that are not a multiple of 16 before any call into the native
library, whose decoder corrupts the heap there (a crash would take the test
worker with it), and still round-trips 16-multiple widths."""

import os
import subprocess

import numpy as np
import pytest

from videoseal_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _NoLibrary:
    """Stands in for the runtime: any use of the library fails the test."""

    def load(self):
        raise AssertionError("video_roundtrip called into the native library")


@pytest.mark.parametrize("w", [200, 120, 854, 1080, 8])
def test_unsafe_width_refused_before_the_library(w, monkeypatch):
    monkeypatch.setattr(native, "_runtime", _NoLibrary())
    frames = np.zeros((2, 32, w, 3), np.uint8)
    with pytest.raises(ValueError, match=f"width {w} is not a multiple of 16"):
        native.video_roundtrip(frames, "h264", crf=28)


@pytest.mark.parametrize("h,w", [(64, 256), (32, 16 * 7), (36, 96), (35, 96)])
def test_16_multiple_widths_round_trip(h, w):
    if not (native.available() and native.codec_available("h264")):
        pytest.skip(f"the native media runtime does not load here: {native.last_error()}")
    rng = np.random.default_rng(w)
    frames = rng.uniform(0, 1, (4, h, w, 3)).astype(np.float32)
    out = native.video_roundtrip(frames, "h264", crf=18)
    assert out.shape == frames.shape and out.dtype == np.float32
    assert 0.0 <= out.min() and out.max() <= 1.0
    assert np.abs(out - frames).mean() < 0.25


def test_native_tree_clean_after_round_trips():
    if not os.path.isdir(os.path.join(ROOT, ".git")):
        pytest.skip("not a git checkout")
    out = subprocess.run(["git", "status", "--porcelain", "native/"], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out == "", out
