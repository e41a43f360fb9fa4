"""ctypes bindings for the native media runtime (``native/media.cpp``, libav*).

Counterpart of ``videoseal_tpu/native/__init__.py``: frame readers and
writers, file encoding, the exact codec round trip and audio muxing. The
planar reader fills the port's serving layout (``kernels/fused_planar.py``:
the image at rows [R0, R0+H), cols [C0, C0+W) of a zero-padded buffer).

Loading never writes under ``native/``: it first loads the committed
``native/libvideoseal_media.so``; if that fails (for example, another libav
soname on this machine), it builds ``native/media.cpp`` with g++ into
``videoseal_tpu_torch/_build/media/<hash>/`` and loads that. If both fail,
``available()`` is False and ``last_error()`` says why. ctypes releases the
interpreter lock during every native call, so a decoder or encoder thread
runs beside the main thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .kernels.fused_planar import C0, R0, planar_shape

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "media.cpp")
_COMMITTED = os.path.join(_ROOT, "native", "libvideoseal_media.so")
_BUILD_ROOT = os.path.join(_ROOT, "videoseal_tpu_torch", "_build", "media")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vsm_last_error": ([], ctypes.c_char_p),
    "vsm_codec_available": ([ctypes.c_char_p], _I),
    "vsm_video_roundtrip": ([_P, _I, _I, _I, ctypes.c_char_p, _I, _I, _P], _I),
    "vsm_open": ([ctypes.c_char_p], _P),
    "vsm_info": ([_P] * 5, _I),
    "vsm_read": ([_P, _P, _I], _I),
    "vsm_read_planar": ([_P, _P] + [_I] * 5, _I),
    "vsm_seek_frame": ([_P, ctypes.c_int64], _I),
    "vsm_close": ([_P], None),
    "vsm_encode_file": ([ctypes.c_char_p, _P, _I, _I, _I, ctypes.c_char_p, _I, _I], _I),
    "vsm_mux_audio": ([ctypes.c_char_p] * 3, _I),
    "vsm_enc_open": ([ctypes.c_char_p, _I, _I, ctypes.c_char_p, _I, _I], _P),
    "vsm_enc_write": ([_P, _P, _I], _I),
    "vsm_enc_write_planar": ([_P, _P] + [_I] * 5, _I),
    "vsm_enc_close": ([_P], _I),
}


class _Runtime:
    """A handle on the library, loaded at first use: the committed one, else
    a build of `src` under `build_root`. The module holds the process's one."""

    def __init__(self, committed: str = _COMMITTED, src: str = _SRC,
                 build_root: str = _BUILD_ROOT):
        self.committed, self.src, self.build_root = committed, src, build_root
        self.lock = threading.Lock()
        self.tried = False
        self.lib = None
        self.origin = None      # the path of the library that loaded
        self.error = ""         # why neither library loaded

    def load(self):
        with self.lock:
            if not self.tried:
                self.tried = True
                self._load()
            return self.lib

    def _load(self) -> None:
        try:
            self._bind(self.committed)
            return
        except OSError as e:
            committed_error = str(e)
        try:
            self._bind(_build(self.src, self.build_root))
        except (OSError, RuntimeError) as e:
            self.error = f"{e} (committed library: {committed_error})"

    def _bind(self, path: str) -> None:
        lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        self.lib, self.origin = lib, path


def _build(src: str, build_root: str) -> str:
    """g++ of `src` into build_root/<hash>/; the path of the library, or
    RuntimeError with g++'s first error line."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:12]
    out_dir = os.path.join(build_root, key)
    so = os.path.join(out_dir, "libvideoseal_media.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp, *LIBS],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++: {e}") from e
    if proc.returncode != 0:
        lines = proc.stderr.splitlines()
        first = next((ln for ln in lines if "error" in ln), lines[0] if lines else "")
        raise RuntimeError(f"g++ failed: {first.strip()}")
    os.replace(tmp, so)
    return so


_runtime = _Runtime()


def _lib():
    lib = _runtime.load()
    if lib is None:
        raise RuntimeError(f"native media runtime unavailable: {_runtime.error}")
    return lib


def available() -> bool:
    return _runtime.load() is not None


def origin() -> str | None:
    """The path of the library that loaded: the committed one or a _build/ copy."""
    _runtime.load()
    return _runtime.origin


def last_error() -> str:
    """Why the library did not load, or the library's own last error."""
    lib = _runtime.load()
    return lib.vsm_last_error().decode() if lib is not None else _runtime.error


def codec_available(codec: str) -> bool:
    lib = _runtime.load()
    return bool(lib and lib.vsm_codec_available(codec.encode()))


def _to_u8(frames: np.ndarray) -> np.ndarray:
    if frames.dtype == np.uint8:
        return np.ascontiguousarray(frames)
    return np.ascontiguousarray(np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _out_buffer(out: np.ndarray | None, shape: tuple) -> np.ndarray:
    if out is None:
        return np.zeros(shape, np.uint8)
    if out.dtype != np.uint8 or tuple(out.shape[1:]) != tuple(shape[1:]) \
            or out.shape[0] < shape[0] or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint8 of at least {shape}, got "
                         f"{out.dtype} {out.shape}")
    return out


def video_roundtrip(frames: np.ndarray, codec: str = "h264", crf: int = 28,
                    fps: int = 24) -> np.ndarray:
    """The exact codec attack: encode and decode (F, H, W, 3) frames ([0, 1]
    float or u8); odd sizes are padded to even. Returns float32 in [0, 1]."""
    lib = _lib()
    u8 = _to_u8(frames)
    f, h, w, _ = u8.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        u8 = np.pad(u8, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    out = np.empty_like(u8)
    n = lib.vsm_video_roundtrip(_ptr(u8), f, u8.shape[1], u8.shape[2], codec.encode(),
                                int(crf), int(fps), _ptr(out))
    if n < 0:
        raise RuntimeError(f"roundtrip failed: {lib.vsm_last_error().decode()}")
    if ph or pw:
        out = out[:, :h, :w]
    return out.astype(np.float32) / 255.0


class VideoReader:
    """Sequential, seekable frame reader."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.vsm_open(path.encode())
        if not self._h:
            raise IOError(self._lib.vsm_last_error().decode())
        w, ht, fps, nf = ctypes.c_int(), ctypes.c_int(), ctypes.c_double(), ctypes.c_int64()
        self._lib.vsm_info(self._h, ctypes.byref(w), ctypes.byref(ht), ctypes.byref(fps),
                           ctypes.byref(nf))
        self.width, self.height = w.value, ht.value
        self.fps, self.nframes = fps.value, nf.value
        if self.width % 16:
            self.close()
            raise ValueError(f"{path}: width {self.width} is not a multiple of 16; the native "
                             "reader's RGB conversion then writes past its buffers (heap "
                             "corruption), so the port refuses it")

    def read(self, n: int, out: np.ndarray | None = None) -> np.ndarray:
        """Up to n frames, (got, H, W, 3) RGB u8, into `out` if given."""
        buf = _out_buffer(out, (n, self.height, self.width, 3))
        got = self._lib.vsm_read(self._h, _ptr(buf), n)
        return buf[:got]

    def read_planar(self, n: int, out: np.ndarray | None = None) -> np.ndarray:
        """Up to n frames decoded straight into the padded planar layout
        (``planar_shape``), into `out` if given: its pad must be zero, and
        stays as it is (the decoder writes the image only)."""
        shape = planar_shape(n, self.height, self.width)
        buf = _out_buffer(out, shape)
        got = self._lib.vsm_read_planar(self._h, _ptr(buf), n, shape[2], shape[3], R0, C0)
        return buf[:got]

    def seek(self, frame_idx: int) -> None:
        self._lib.vsm_seek_frame(self._h, int(frame_idx))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vsm_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class VideoWriter:
    """Incremental encoder (libx264 and the others at a given crf)."""

    def __init__(self, path: str, w: int, h: int, codec: str = "h264", crf: int = 18,
                 fps: float = 24.0):
        self._lib = _lib()
        self.w, self.h = w, h
        self._h = self._lib.vsm_enc_open(path.encode(), w, h, codec.encode(), int(crf),
                                         int(round(fps)))
        if not self._h:
            raise RuntimeError(self._lib.vsm_last_error().decode())

    def write(self, frames: np.ndarray) -> int:
        """frames: (N, H, W, 3) u8 interleaved RGB."""
        u8 = np.ascontiguousarray(frames)
        if u8.dtype != np.uint8 or u8.shape[1:] != (self.h, self.w, 3):
            raise ValueError(f"expected (N, {self.h}, {self.w}, 3) uint8, got "
                             f"{u8.dtype} {u8.shape}")
        return self._lib.vsm_enc_write(self._h, _ptr(u8), u8.shape[0])

    def write_planar(self, frames_p: np.ndarray, r0: int = 0, c0: int = 0) -> int:
        """frames_p: (N, 3, Hp, Wb) u8 planar, the image at rows [r0, r0+H),
        cols [c0, c0+W) (the blend kernel's output: r0 = c0 = 0)."""
        u8 = np.ascontiguousarray(frames_p)
        if (u8.dtype != np.uint8 or u8.ndim != 4 or u8.shape[1] != 3
                or u8.shape[2] < r0 + self.h or u8.shape[3] < c0 + self.w):
            raise ValueError(f"expected (N, 3, >= {r0 + self.h}, >= {c0 + self.w}) uint8, "
                             f"got {u8.dtype} {u8.shape}")
        return self._lib.vsm_enc_write_planar(self._h, _ptr(u8), u8.shape[0], u8.shape[2],
                                              u8.shape[3], r0, c0)

    def close(self) -> int:
        if getattr(self, "_h", None):
            n = self._lib.vsm_enc_close(self._h)
            self._h = None
            return n
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def encode_file(path: str, frames: np.ndarray, codec: str = "h264", crf: int = 23,
                fps: int = 24) -> None:
    lib = _lib()
    u8 = _to_u8(frames)
    f, h, w, _ = u8.shape
    n = lib.vsm_encode_file(path.encode(), _ptr(u8), f, h, w, codec.encode(), int(crf),
                            int(fps))
    if n < 0:
        raise RuntimeError(f"encode failed: {lib.vsm_last_error().decode()}")


def mux_audio(video_path: str, audio_src_path: str, out_path: str) -> bool:
    """Copy the audio stream(s) of audio_src_path onto video_path's video
    (stream copy, no re-encode). True if an audio stream was copied."""
    lib = _lib()
    r = lib.vsm_mux_audio(video_path.encode(), audio_src_path.encode(), out_path.encode())
    if r < 0:
        raise RuntimeError(f"mux failed: {lib.vsm_last_error().decode()}")
    return bool(r)
