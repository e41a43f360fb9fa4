"""K7: where does the JND delta kernel's time go on the card? (perf tool,
not a serving path)

Counterpart of ``videoseal_tpu/kernels/jnd_probe.py``. The TPU probe built
four kernels on K5's grid; here they are instances of K5's own CUDA kernel
(``csrc/jnd_probe.cu`` on ``jnd_delta.cuh``, heat in ``jnd_heat.cuh``), so
every variant times the production staging of NHWC frames with parts
switched off:

  copy         stage the luminance, write sw * lum(y, x - 2) + pred (the
               TPU probe read its padded plane two columns left of the
               centre; mirrored exactly, so the tests compare unshifted)
  sums         the 5x5/3x3 luminance sums and the Sobel, no
               transcendentals: (sw * (la + cm2)) * pred
  full         the heat through sqrt(cm2)^2.4
  full_nosqrt  the production heat, cm2^1.2: K5 itself

and the TPU's row-tile sweep becomes a sweep of the strip height ``rs``
(rows per block; K4-K6 use 8). The probe reads f32 frames, as the TPU probe
read f32 planes, and the u8 frames of K4's route.

Run on the card: python -m videoseal_tpu_torch.kernels.jnd_probe
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from . import _lib
from . import fused_blend as fb

MODES = ("copy", "sums", "full", "full_nosqrt")   # csrc HeatMode, in order
RS_SWEEP = (4, 8, 16, 32)


def _check_args(mode: str, rs: int) -> None:
    if mode not in MODES or rs not in RS_SWEEP:
        raise ValueError(f"jnd_probe takes mode in {MODES} and rs in {RS_SWEEP}, "
                         f"got {mode!r}, {rs}")


def jnd_probe_plain(imgs: torch.Tensor, pred: torch.Tensor, scaling_w, mode: str,
                    rs: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K7 (rs, the strip height, changes no result)."""
    _check_args(mode, rs)
    if mode == "copy":
        lum = fb._luminance(imgs)
        return float(scaling_w) * F.pad(lum, (2, 0))[..., :lum.shape[-1]] + pred.float()
    return (float(scaling_w) * fb._heat_plain(imgs, mode)) * pred.float()


def _probe_cuda(imgs, pred, scaling_w, mode, rs):
    _check_args(mode, rs)
    f, h, w = fb._check_frames("jnd_probe", imgs, (torch.uint8, torch.float32))
    fb._check_plane("jnd_probe", pred, (f, h, w), (torch.float32,), imgs.device)
    out = torch.empty((f, h, w), dtype=torch.float32, device=imgs.device)
    _lib.check(_lib.library().vs_jnd_probe(
        imgs.data_ptr(), int(imgs.dtype == torch.uint8), pred.data_ptr(), out.data_ptr(),
        f, h, w, *fb._lum_weights(imgs), float(scaling_w), MODES.index(mode), rs,
        _lib.stream_ptr(imgs)), "vs_jnd_probe")
    return out


def jnd_probe(imgs: torch.Tensor, pred: torch.Tensor, scaling_w, mode: str,
              rs: int = 8) -> torch.Tensor:
    """K7. imgs (F, H, W, 3) u8 or [0, 1] f32; pred (F, H, W) f32. Returns
    (F, H, W) f32, the variant `mode` of K5's delta with `rs` rows per
    block."""
    return fb._dispatch(jnd_probe, jnd_probe_plain, _probe_cuda, imgs, pred, scaling_w, mode,
                        rs)


jnd_probe.launches = 0


def probe_inputs(frames: int, h: int, w: int, dtype: torch.dtype, device,
                 seed: int = 0) -> tuple:
    """The probe's inputs: random u8 or [0, 1) f32 frames (F, h, w, 3) and a
    prediction (F, h, w) in [-1, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.uint8:
        imgs = torch.randint(0, 256, (frames, h, w, 3), generator=g, device=device,
                             dtype=torch.uint8)
    else:
        imgs = torch.rand((frames, h, w, 3), generator=g, device=device, dtype=dtype)
    return imgs, torch.rand((frames, h, w), generator=g, device=device) * 2 - 1


def run(mode: str, rs: int, frames: int = 128, h: int = 1080, w: int = 1920,
        dtype: torch.dtype = torch.float32, reps: int = 3) -> dict:
    """Time one variant on the card at F frames of h x w (`probe_inputs`,
    seed 0) and print its JSON line; eff_GBps counts the frames and the
    prediction read and the output written once."""
    from ..utils.timing import cuda_ms
    imgs, pred = probe_inputs(frames, h, w, dtype, torch.device("cuda"))
    ms = cuda_ms(lambda: jnd_probe(imgs, pred, 0.2, mode, rs), reps)
    nbytes = imgs.numel() * imgs.element_size() + 2 * pred.numel() * 4
    rec = {"mode": mode, "rs": rs, "dtype": str(dtype).removeprefix("torch."), "ms": ms,
           "eff_GBps": nbytes / ms / 1e6}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> list[dict]:
    """The TPU probe's sweep, on f32 and on u8 frames: every mode at rs=8,
    then "full" at the other strip heights."""
    recs = []
    for dtype in (torch.float32, torch.uint8):
        for mode in MODES:
            recs.append(run(mode, 8, dtype=dtype))
        for rs in (4, 16, 32):
            recs.append(run("full", rs, dtype=dtype))
    return recs


if __name__ == "__main__":
    main()
