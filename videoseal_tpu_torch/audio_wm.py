"""Spread-spectrum audio watermarking for the AV pipeline, counterpart of
``videoseal_tpu/audio_wm.py``.

The reference watermarks the audio track with AudioSeal (its
inference_av.py:83-108), an external learned model family. This is the
JAX package's self-contained classical alternative: band-limited
direct-sequence spread spectrum. Each message bit modulates a keyed
pseudo-noise chip sequence added at a fixed SNR below the local signal
level; detection is a matched-filter correlation. Robust to volume changes,
additive noise, clipping and moderate lossy re-encoding; not to time shifts
or resampling (no sync search).

The chip sequences are made on the host with numpy exactly as the JAX
package makes them (``np.random.default_rng(key)``, numpy's rfft band
limit), cached per sample rate and moved to the device once; `embed` and
`detect` run as torch ops on the device (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the audio watermark runs on the CUDA device by default and none is "
                           "available; pass device='cpu' to run it on the CPU")
    return device


class SpreadSpectrumAudio:
    """Direct-sequence spread-spectrum watermark on PCM audio.

    nbits message bits; each bit occupies every nbits-th frame of
    `chip_seconds`, so audio of any length accumulates correlation for
    every bit. The PN sequence is keyed and band-passed to `band` Hz."""

    def __init__(self, nbits: int = 16, key: int = 0, chip_seconds: float = 0.05,
                 snr_db: float = 30.0, band=(1000.0, 8000.0), device="cuda"):
        self.nbits = nbits
        self.key = key
        self.chip_seconds = chip_seconds
        self.snr_db = snr_db
        self.band = band
        self.device = _device(device)
        self._pn_cache: dict[int, torch.Tensor] = {}

    def _frame_len(self, sr: int) -> int:
        return max(int(round(self.chip_seconds * sr)), 64)

    def _pn(self, sr: int) -> torch.Tensor:
        """(nbits, L) band-limited unit-RMS chip sequences on the device,
        one per bit position, reused cyclically along time."""
        if sr not in self._pn_cache:
            L = self._frame_len(sr)
            rng = np.random.default_rng(self.key)
            pn = rng.choice(np.float64([-1.0, 1.0]), size=(self.nbits, L))
            f = np.fft.rfftfreq(L, 1.0 / sr)
            keep = (f >= self.band[0]) & (f <= min(self.band[1], sr / 2 * 0.95))
            if keep.any():
                spec = np.fft.rfft(pn, axis=-1)
                spec[:, ~keep] = 0.0
                pn = np.fft.irfft(spec, n=L, axis=-1)
            pn /= np.sqrt(np.mean(pn * pn, axis=-1, keepdims=True)) + 1e-12
            self._pn_cache[sr] = torch.from_numpy(pn.astype(np.float32)).to(self.device)
        return self._pn_cache[sr]

    def _pcm(self, audio) -> torch.Tensor:
        """(C, T) float32 on the device from (T,) or (C, T) audio."""
        x = torch.as_tensor(audio).to(self.device, torch.float32)
        return x[None] if x.dim() == 1 else x

    def get_random_msg(self, generator: torch.Generator | None = None) -> torch.Tensor:
        """(nbits,) int32 0/1 bits on the device, from `generator` where given."""
        dev = generator.device if generator is not None else self.device
        return torch.randint(0, 2, (self.nbits,), generator=generator,
                             device=dev).to(self.device, torch.int32)

    def embed(self, audio, sr: int, msg) -> torch.Tensor:
        """audio: (T,) or (C, T) float in [-1, 1] (numpy or torch); msg:
        (nbits,) 0/1. The watermarked audio, float32 on the device, in
        audio's shape."""
        msg = torch.as_tensor(msg).reshape(-1).to(self.device)
        assert msg.shape == (self.nbits,), msg.shape
        squeeze = torch.as_tensor(audio).dim() == 1
        x = self._pcm(audio).clone()
        L = self._frame_len(sr)
        n = x.shape[-1] // L
        if n > 0:
            pn = self._pn(sr)
            sgn = 2.0 * msg.float() - 1.0
            gain = 10.0 ** (-self.snr_db / 20.0)
            head = x[:, :n * L].view(x.shape[0], n, L)
            rms = torch.sqrt(torch.mean(head * head, dim=-1, keepdim=True))
            rms = torch.clamp(rms, min=1e-3)    # floor: stay detectable in silence
            bit_idx = torch.arange(n, device=self.device) % self.nbits
            w = pn[bit_idx] * sgn[bit_idx, None]                 # (n, L)
            head += gain * rms * w[None]
            x = torch.clamp(x, -1.0, 1.0)
        return x[0] if squeeze else x

    def detect(self, audio, sr: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(bits (nbits,) int32, confidence (nbits,) float32), on the device.

        Confidence is the normalised matched-filter statistic per bit
        (|corr| / frame RMS): ~1.5-2 on watermarked audio at the default SNR
        against ~0.1-0.3 incidental correlation on clean audio."""
        x = self._pcm(audio)
        L = self._frame_len(sr)
        n = x.shape[-1] // L
        bits = torch.zeros(self.nbits, dtype=torch.int32, device=self.device)
        conf = torch.zeros(self.nbits, dtype=torch.float32, device=self.device)
        if n == 0:
            return bits, conf
        pn = self._pn(sr)
        head = x[:, :n * L].reshape(x.shape[0], n, L).mean(dim=0)           # (n, L)
        bit_idx = torch.arange(n, device=self.device) % self.nbits
        corr = torch.sum(head * pn[bit_idx], dim=-1) / L
        norm = torch.sqrt(torch.mean(head * head, dim=-1)) + 1e-12
        zeros = torch.zeros(self.nbits, dtype=torch.float32, device=self.device)
        c_sum = zeros.index_add(0, bit_idx, corr).double()
        n_sum = zeros.index_add(0, bit_idx, norm).double()
        seen = torch.bincount(bit_idx, minlength=self.nbits) > 0
        c = torch.where(seen, c_sum / torch.where(seen, n_sum, 1.0) * math.sqrt(L), 0.0)
        return (c > 0).to(torch.int32), c.abs().float()


def _ffmpeg() -> str | None:
    return shutil.which("ffmpeg")


def watermark_audio_file(input_path: str, msg, wm: SpreadSpectrumAudio | None = None,
                         sr: int = 48000, device="cuda") -> str | None:
    """Extract the audio track of `input_path` with ffmpeg, watermark it on
    the device, and return the path of a wav file carrying the watermarked
    track: None when the input has no audio or ffmpeg is missing, as in
    the JAX package. An ``audio_processor`` for ``inference_av.embed_av``."""
    ff = _ffmpeg()
    if ff is None:
        return None
    wm = wm or SpreadSpectrumAudio(nbits=torch.as_tensor(msg).numel(), device=device)
    raw = subprocess.run(
        [ff, "-v", "error", "-i", input_path, "-map", "a:0?", "-ac", "2",
         "-ar", str(sr), "-f", "f32le", "-"],
        capture_output=True)
    if raw.returncode != 0 or not raw.stdout:
        return None
    pcm = np.frombuffer(raw.stdout, np.float32).reshape(-1, 2).T
    out = wm.embed(pcm, sr, msg)
    inter = np.ascontiguousarray(out.T.cpu().numpy(), np.float32)
    fd, path = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    enc = subprocess.run(
        [ff, "-v", "error", "-y", "-f", "f32le", "-ac", "2", "-ar", str(sr),
         "-i", "-", "-c:a", "pcm_s16le", path],
        input=inter.tobytes(), capture_output=True)
    if enc.returncode != 0:
        os.remove(path)
        return None
    return path


def make_audio_processor(msg, wm: SpreadSpectrumAudio | None = None, device="cuda"):
    """The ``audio_processor`` for ``inference_av.embed_av``: the input
    file itself where extraction or ffmpeg fails."""
    def processor(input_path: str) -> str:
        out = watermark_audio_file(input_path, msg, wm, device=device)
        return out if out is not None else input_path
    return processor
