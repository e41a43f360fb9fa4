"""Snapshot images and videos via cv2, counterpart of
``videoseal_tpu/utils/display.py``."""

from __future__ import annotations

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_img(img: np.ndarray, path: str) -> None:
    """(H, W, 3) [0,1] RGB -> an image file."""
    import cv2
    cv2.imwrite(path, _to_u8(img)[..., ::-1])


def save_vid(frames: np.ndarray, path: str, fps: float = 24.0,
             codec: str = "mp4v") -> None:
    """(F, H, W, 3) [0,1] RGB -> a video file."""
    import cv2
    u8 = _to_u8(frames)
    f, h, w, _ = u8.shape
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
    for i in range(f):
        vw.write(u8[i][..., ::-1])
    vw.release()


def get_fps(path: str) -> float:
    """A video file's frame rate, 24 where the container gives none."""
    import cv2
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    cap.release()
    return fps


def create_diff_img(a: np.ndarray, b: np.ndarray, gain: float = 10.0) -> np.ndarray:
    """|a - b| amplified by `gain`, clipped to [0, 1]."""
    return np.clip(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
                   * gain, 0, 1)
