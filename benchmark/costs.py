"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel could take, the bytes and operations of the port's kernels K1, K2
and K4 from their shapes, and the model FLOPs of a request counted on the
reference.

The peaks are NVIDIA's for one H100 SXM (dense, without sparsity), which
assume its full 700 W power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import nets
from .reference.resize import resize_matrix_np

HBM_BPS = 3.35e12      # bytes/s
BF16_FLOPS = 989e12    # tensor-core FLOP/s, bf16 and fp16
F32_FLOPS = 67e12      # CUDA-core FLOP/s, float32
# float32 operations a pixel of the JND heat and the luminance before it
# (sqrt, log, exp and one division counted as one each)
HEAT_OPS = 85
# output rows of the planar layout's tiles and the width its rows round to
TILE_ROWS, ROW_ALIGN = 96, 128


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0) -> tuple[float, str]:
    """Least time (ms): the larger of the bytes over the memory rate and the
    operations over the peak rate of their type. Tensor cores and CUDA cores
    run at once, so the operations take the larger of their two times."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(f32_ops / F32_FLOPS, bf16_ops / BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def taps(m: np.ndarray, least: int = 1) -> int:
    """The widest span of nonzero weights of any row of a resampling matrix."""
    nz = m != 0
    rows = nz.any(axis=1)
    first = nz.argmax(axis=1)
    last = m.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)
    return int(max((last - first + 1)[rows].max(initial=1), least))


def k1_cost(f: int, h: int, w: int, s: int, lowres: bool, ds: int) -> tuple[float, float]:
    """K1 (the planar blend) on f frames: (bytes, f32 operations). It reads
    each u8 plane of the (hout, wq) window it writes (the JND's halo comes
    back from L2), the f32 prediction, and writes the u8 planes and, with a
    detect size ds, the f32 detect input. Per output pixel: the width taps
    of each lift tap, the lift and the blend of three planes, with the JND;
    with ds the two banded downscale products."""
    hout = TILE_ROWS * -(-h // TILE_ROWS)
    wq = ROW_ALIGN * -(-w // ROW_ALIGN)
    lt, wt = taps(resize_matrix_np(s, h)), taps(resize_matrix_np(s, w), 2)
    px = f * hout * wq
    nbytes = 2 * f * 3 * hout * wq + f * s * s * 4 + (f * 3 * ds * ds * 4 if ds else 0)
    ops = px * (lt * (2 * wt + 2) + 3 * 4 + (0 if lowres else HEAT_OPS))
    if ds:
        ops += (f * 3 * hout * ds * 2 * taps(resize_matrix_np(w, ds))
                + f * 3 * ds * ds * 2 * taps(resize_matrix_np(h, ds)))
    return nbytes, ops


def k4_cost(f: int, h: int, w: int, s: int) -> tuple[float, float]:
    """K4's blend mode on f u8 NHWC frames: (bytes, f32 operations). It reads
    the frames and the f32 prediction at the processing size once and writes
    the u8 frames; per pixel the width taps of each lift tap, the lift, the
    JND, the delta, and 3 operations a value of the blend."""
    lt, wt = taps(resize_matrix_np(s, h)), taps(resize_matrix_np(s, w), 2)
    px = f * h * w
    return 2 * px * 3 + f * s * s * 4, px * (HEAT_OPS + lt * (2 * wt + 2) + 2) + 3 * px * 4


def block_cost(h: int, w: int, c: int, frames: int = 32, k: int = 1) -> tuple:
    """k ConvNeXt blocks over `frames` frames of h x w x c, bf16 in and out:
    (bytes of x and the output, each moved once, and of k weight sets; bf16
    tensor-core operations of the pointwise products; f32 operations of the
    depthwise conv, LN, GELU and GRN)."""
    px = frames * h * w
    nbytes = 2 * px * c * 2 + k * (49 * c * 4 + 2 * 4 * c * c * 2 + 15 * c * 4)
    return (nbytes, k * 2 * 2 * px * c * 4 * c,
            k * (px * c * (2 * 49 + 10) + px * 4 * c * 12))


def k2_bound_ms(card: dict, frames: int) -> float:
    """The least time of every K2 block of one extractor pass over `frames`
    frames, at the card's stage shapes and true widths."""
    total = 0.0
    for depth, h, w, c in nets.stage_shapes(card):
        nbytes, bf16_ops, f32_ops = block_cost(h, w, c, frames=frames)
        total += depth * bound(nbytes, f32_ops=f32_ops, bf16_ops=bf16_ops)[0]
    return total


def model_flops(card: dict, keys: int = 0, detect_frames: int = 0) -> float:
    """FLOPs of the reference's embedder over `keys` key frames and its
    extractor over `detect_frames` frames at the processing size, counted by
    torch's FlopCounterMode on meta tensors (the convolutions and products,
    2 a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    from . import program
    s, nbits = card["args"]["img_size_proc"], card["args"]["nbits"]
    sd = {k: torch.empty(v, device="meta") for k, v in program.state_shapes(card).items()}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        if keys:
            nets.embedder(sd, card, torch.empty(keys, s, s, 3, device="meta"),
                          torch.zeros(keys, nbits, dtype=torch.long, device="meta"), nets.Ops())
        if detect_frames:
            nets.extractor(sd, card, torch.empty(detect_frames, s, s, 3, device="meta"),
                           nets.Ops())
    return float(counter.get_total_flops())
