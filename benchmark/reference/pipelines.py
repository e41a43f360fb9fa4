"""The cards' serving paths in plain float32, from u8 NHWC frames.

`embed_video` is the video embed: key frames (every `step`-th) resized to
the processing size, the embedder's prediction for them, each prediction
repeated over the `step` frames it stands for, then either the JND of the
processing-size frames times the prediction (`lowres`) or the JND of the
full-size frames times the upsampled prediction, and the additive blend
rounded to u8. `detect` resizes u8 frames to the processing size and runs
the extractor. Both work through the frames in blocks, so that the 1080p
float32 tensors of a 128-frame clip never live at once.
"""

from __future__ import annotations

import contextlib

import torch

from . import nets
from .resize import resize


@contextlib.contextmanager
def exact_float32():
    """TF32 off in cuBLAS and cuDNN while the reference runs, so that a
    float32 product is a float32 product."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _args(card: dict) -> tuple[int, int, float, float]:
    a = card["args"]
    if a.get("attenuation") != "jnd_1_1" or a.get("blending_method", "additive") != "additive":
        raise NotImplementedError("the reference embeds with jnd_1_1 and additive blending")
    if a.get("video_mode", "repeat") != "repeat":
        raise NotImplementedError("the reference expands key frames by repeating them")
    return (a["img_size_proc"], a.get("videoseal_step_size", 4), float(a["scaling_w"]),
            float(a.get("scaling_i", 1.0)))


def embed_video(sd: dict, card: dict, frames: torch.Tensor, msg: torch.Tensor,
                lowres: bool, ops: nets.Ops = nets.Ops(), block: int = 16) -> torch.Tensor:
    """frames (F, H, W, 3) u8, msg (nbits,) bits -> watermarked (F, H, W, 3) u8."""
    s, step, sw, si = _args(card)
    n, h, w, _ = frames.shape
    unit = lambda a: a.float() * (1.0 / 255.0)
    with exact_float32():
        if lowres:
            small = torch.cat([resize(unit(frames[i:i + block]), s, s)
                               for i in range(0, n, block)])
            keys = small[::step]
        else:
            keys = torch.cat([resize(unit(frames[i:i + block:step]), s, s)
                              for i in range(0, n, block)])
        msgs = msg.reshape(1, -1).expand(keys.shape[0], -1)
        preds = torch.cat([nets.embedder(sd, card, keys[i:i + 32], msgs[i:i + 32], ops)
                           for i in range(0, keys.shape[0], 32)])
        preds = preds.repeat_interleave(step, dim=0)[:n]
        if lowres:
            preds = nets.jnd_heat(small) * preds
        out = torch.empty_like(frames)
        for i in range(0, n, block):
            x = frames[i:i + block].float()
            pred = resize(preds[i:i + block], h, w)
            if not lowres:
                pred = nets.jnd_heat(x * (1.0 / 255.0)) * pred
            out[i:i + block] = torch.clamp(torch.round(si * x + 255.0 * sw * pred),
                                           0.0, 255.0).to(torch.uint8)
    return out


def detect(sd: dict, card: dict, frames: torch.Tensor, ops: nets.Ops = nets.Ops(),
           block: int = 32) -> torch.Tensor:
    """frames (F, H, W, 3) u8 -> logits (F, 1 + nbits) float32."""
    s = card["args"]["img_size_proc"]
    with exact_float32():
        return torch.cat([
            nets.extractor(sd, card, resize(frames[i:i + block].float() * (1.0 / 255.0), s, s),
                           ops)
            for i in range(0, frames.shape[0], block)])
