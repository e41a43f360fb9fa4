"""VMAF perceptual video quality, counterpart of ``videoseal_tpu/evals/vmaf.py``.

VMAF needs an ffmpeg binary built with libvmaf, found as $VSM_FFMPEG or
``ffmpeg`` on $PATH and checked for the filter. Without one,
``vmaf_available()`` is False and the scores are None (the eval then skips
its VMAF and BD-rate columns). Videos are written through the native media
runtime (``native.encode_file``) at the codec and CRF given.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=1)
def find_ffmpeg() -> str | None:
    """An ffmpeg binary with the libvmaf filter, or None."""
    candidates = [c for c in (os.environ.get("VSM_FFMPEG"), shutil.which("ffmpeg")) if c]
    for cand in candidates:
        try:
            out = subprocess.run([cand, "-hide_banner", "-filters"],
                                 capture_output=True, text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if "libvmaf" in out.stdout:
            return cand
    return None


def vmaf_available() -> bool:
    return find_ffmpeg() is not None


def vmaf_on_file(vid_o: str, vid_w: str, n_threads: int = 8) -> float | None:
    """The pooled VMAF score of `vid_w` against `vid_o`, or None without a
    libvmaf-capable ffmpeg (or when ffmpeg printed no score)."""
    ffmpeg = find_ffmpeg()
    if ffmpeg is None:
        return None
    cmd = [ffmpeg, "-i", vid_o, "-i", vid_w,
           "-lavfi", f"libvmaf='n_threads={n_threads}'", "-f", "null", "-"]
    result = subprocess.run(cmd, text=True, capture_output=True)
    for line in result.stderr.split("\n"):
        m = re.search(r"VMAF score: ([0-9.]+)", line)
        if m:
            return float(m.group(1))
    return None


def vmaf_on_tensor(frames1: np.ndarray, frames2: np.ndarray | None = None, fps: int = 24,
                   codec: str = "h264", crf: int = 23, return_aux: bool = False):
    """VMAF between two (F, H, W, 3) frame arrays in [0, 1] or u8; with
    frames2=None, frames1 against its own codec round trip (the reference
    written at CRF 0, the near-lossless analogue of the reference's
    unencoded file). Returns the score (None without libvmaf) and, with
    return_aux, the two files' sizes (MB), durations (s) and rates (MB/s)."""
    from .. import native

    if not native.available():
        raise RuntimeError(f"native media runtime unavailable: {native.last_error()}")
    with tempfile.TemporaryDirectory() as td:
        f1, f2 = os.path.join(td, "ref.mp4"), os.path.join(td, "dist.mp4")
        if frames2 is None:
            native.encode_file(f1, frames1, codec="h264", crf=0, fps=fps)
            frames2 = frames1
        else:
            native.encode_file(f1, frames1, codec=codec, crf=crf, fps=fps)
        native.encode_file(f2, frames2, codec=codec, crf=crf, fps=fps)
        score = vmaf_on_file(f1, f2)
        if not return_aux:
            return score
        mb = 1024 * 1024
        s1, s2 = os.path.getsize(f1) / mb, os.path.getsize(f2) / mb
        d1, d2 = len(frames1) / fps, len(frames2) / fps
        return score, {"filesize1": s1, "filesize2": s2, "duration1": d1,
                       "duration2": d2, "bps1": s1 / d1, "bps2": s2 / d2}
