"""The numbers that decide `correct`: how far the program's outputs lie
from the reference's, each taken at its worst frame, so that one frame
gone wrong shows as plainly as a whole clip."""

from __future__ import annotations

import torch


def _mean_abs(a: torch.Tensor, b: torch.Tensor, block: int = 8) -> torch.Tensor:
    """(F,) each frame's mean |a - b| of two u8 (F, ...) clips, on b's
    device, a few frames at a time: a 2160p clip's int32 copy is 12 GB."""
    return torch.cat([(a[i:i + block].to(b.device).int() - b[i:i + block].int()).abs().float()
                      .mean(dim=tuple(range(1, a.dim()))) for i in range(0, a.shape[0], block)])


def marks(ref: torch.Tensor, frames_in: torch.Tensor) -> torch.Tensor:
    """(F,) the mean absolute watermark of each reference frame, u8 steps."""
    return _mean_abs(ref, frames_in)


# the watermark below which a frame's gap is taken over this floor instead:
# half a u8 step, where most of a fainter mark rounds away
MARK_FLOOR = 0.5


def frame_gaps(frames: torch.Tensor, ref: torch.Tensor, mark: torch.Tensor) -> dict:
    """u8 (F, H, W, 3) against the reference's u8 (F, H, W, 3), whose frames
    carry the mean absolute watermark `mark` (F,) in u8 steps. The worst
    frame's mean absolute difference, in u8 steps (`frame_gap_lsb`) and over
    that frame's watermark, or MARK_FLOOR where it is fainter
    (`frame_gap_rel`); the clip's watermark (`mark_lsb`) beside them."""
    d = _mean_abs(frames, ref)
    return {"frame_gap_lsb": float(d.max()),
            "frame_gap_rel": float((d / mark.clamp(min=MARK_FLOOR)).max()),
            "mark_lsb": float(mark.mean())}


def logit_gap(logits: torch.Tensor, ref: torch.Tensor) -> float:
    """(F, 1 + nbits) against (F, 1 + nbits): the largest over frames of the
    RMS of the difference over the RMS of the reference's logits."""
    p, r = logits.to(ref.device).float(), ref.float()
    rms = lambda a: a.square().mean(dim=1).sqrt()
    return float((rms(p - r) / rms(r).clamp(min=1e-12)).max())


def draw_frames(n: int, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, h, w, 3) u8 frames, every value uniform over 0..255: the frames
    the port's scorer draws."""
    return torch.randint(0, 256, (n, h, w, 3), generator=gen, device=device, dtype=torch.uint8)
