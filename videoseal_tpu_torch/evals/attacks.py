"""Host-side exact codec attacks for evaluation, counterpart of
``videoseal_tpu/evals/attacks.py``:

  jpeg / webp          -> cv2.imencode (libjpeg / libwebp round trip)
  h264 / h264rgb / h265 / vp9 / av1
                       -> the native libav runtime (``native.video_roundtrip``,
                          exact CRF control)
  mpeg4 / vp9 / mjpeg  -> cv2.VideoWriter where the native runtime does not
                          load or lacks the codec (no CRF control)

Frames are numpy arrays in [0, 1]; cv2 is imported inside the functions
that use it.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _image_roundtrip(img: np.ndarray, ext: str, flag_name: str, quality: int) -> np.ndarray:
    import cv2
    x = _to_u8(img)
    single = x.ndim == 3
    if single:
        x = x[None]
    out = np.empty_like(x)
    for i in range(x.shape[0]):
        ok, buf = cv2.imencode(ext, x[i][..., ::-1], [getattr(cv2, flag_name), int(quality)])
        if not ok:
            raise RuntimeError(f"cv2 could not encode {ext}")
        out[i] = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    out = out.astype(np.float32) / 255.0
    return out[0] if single else out


def jpeg_exact(img: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg round trip of (..., H, W, 3) RGB in [0, 1]."""
    return _image_roundtrip(img, ".jpg", "IMWRITE_JPEG_QUALITY", quality)


def webp_exact(img: np.ndarray, quality: int) -> np.ndarray:
    """WebP round trip of (..., H, W, 3) RGB in [0, 1]."""
    return _image_roundtrip(img, ".webp", "IMWRITE_WEBP_QUALITY", quality)


_FOURCC = {"mpeg4": ("mp4v", ".mp4"), "vp9": ("VP90", ".mp4"), "mjpeg": ("MJPG", ".avi")}

_NATIVE_CODECS = ("h264", "h264rgb", "h265", "vp9", "av1", "mpeg4", "mjpeg")


def video_codec_exact(frames: np.ndarray, codec: str = "mpeg4", fps: int = 24,
                      quality: float | None = None, crf: int | None = None) -> np.ndarray:
    """A real encode/decode round trip of (F, H, W, 3) RGB float frames:
    the native runtime where it loads and has the codec (CRF control),
    else cv2's FFmpeg (mpeg4, vp9, mjpeg; no CRF)."""
    from .. import native
    if codec in _NATIVE_CODECS and native.available() and native.codec_available(codec):
        return native.video_roundtrip(np.asarray(frames), codec,
                                      crf if crf is not None else 28, fps)
    import cv2
    fourcc, ext = _FOURCC[codec]
    x = _to_u8(frames)
    f, h, w, _ = x.shape
    fd, path = tempfile.mkstemp(suffix=ext)
    os.close(fd)
    try:
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError(f"codec {codec} unavailable")
        if quality is not None:
            vw.set(cv2.VIDEOWRITER_PROP_QUALITY, float(quality))
        for i in range(f):
            vw.write(x[i][..., ::-1])
        vw.release()
        cap = cv2.VideoCapture(path)
        out = np.empty_like(x)
        for i in range(f):
            ret, fr = cap.read()
            if not ret:   # a frame the decoder dropped repeats the previous one
                fr = out[max(i - 1, 0)][..., ::-1]
            out[i] = fr[..., ::-1]
        cap.release()
    finally:
        os.remove(path)
    return out.astype(np.float32) / 255.0


def available_video_codecs() -> list[str]:
    """The codecs `video_codec_exact` can run here."""
    import cv2
    from .. import native
    ok = []
    if native.available():
        ok.extend(c for c in _NATIVE_CODECS if native.codec_available(c))
    for name, (fourcc, ext) in _FOURCC.items():
        if name in ok:
            continue
        fd, path = tempfile.mkstemp(suffix=ext)
        os.close(fd)
        try:
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 24, (64, 64))
            if vw.isOpened():
                ok.append(name)
                vw.release()
        finally:
            os.remove(path)
    return ok
