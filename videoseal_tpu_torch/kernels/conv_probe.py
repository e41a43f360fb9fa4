"""Probe: the UNet's small-width 3x3 convs in three formulations (perf tool,
not a serving path), counterpart of ``videoseal_tpu/kernels/conv_probe.py``.

The folded UNet's encoder and decoder take far longer than their FLOPs at
the card's bf16 rate (``evals/unet_bench.py``). This probe times, at the
JAX probe's three shapes (32 frames: 128^2 at 64 -> 64 channels, 256^2 at
16 -> 16, 64^2 at 128 -> 128), a 3x3 SAME bf16 conv written three ways on
NHWC activations, each with float32 sums and a bf16 result:

  lax_conv    ``F.conv2d`` on a channels_last view (cuDNN on the card), the
              port's serving conv;
  im2col_dot  the nine shifted slices concatenated on channels, one
              (B*H*W, 9*Ci) @ (9*Ci, Co) matmul;
  nine_dots   nine (B*H*W, Ci) @ (Ci, Co) matmuls summed in float32 (each
              product rounded to bf16 first: torch's bf16 matmul returns
              bf16).

No kernel of the port's: cuDNN and cuBLAS, as the JAX probe's are XLA's.
Prints one JSON line a (variant, shape), the JAX probe's keys:
``{"variant", "shape", "ms", "tf_s"}``.

  python -m videoseal_tpu_torch.kernels.conv_probe [--k 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.timing import cuda_ms, device_info, host_ms

# (B, H=W, Ci, Co): the JAX probe's shapes
SHAPES = ((32, 128, 64, 64), (32, 256, 16, 16), (32, 64, 128, 128))
VARIANTS = ("lax_conv", "im2col_dot", "nine_dots")


def probe_inputs(b: int, h: int, c_in: int, c_out: int, device, seed: int = 0) -> tuple:
    """The JAX probe's inputs from numpy's seed: x ~ N(0, 1) (B, H, H, Ci)
    and an HWIO weight ~ N(0, 0.05), both bf16."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0, 1, (b, h, h, c_in)), dtype=torch.float32, device=device)
    w = torch.as_tensor(rng.normal(0, 0.05, (3, 3, c_in, c_out)), dtype=torch.float32,
                        device=device)
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


def _slices(x: torch.Tensor) -> list:
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def variant_fn(variant: str, x: torch.Tensor, w: torch.Tensor):
    """fn() computing `variant` of the SAME conv of x (B, H, W, Ci) with the
    HWIO weight w, -> (B, H, W, Co) bf16."""
    b, h, ww, c_in = x.shape
    c_out = w.shape[-1]
    if variant == "lax_conv":
        wk = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(x.permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    if variant == "im2col_dot":
        wk = w.reshape(9 * c_in, c_out)
        return lambda: (torch.cat(_slices(x), dim=-1).reshape(b * h * ww, 9 * c_in) @ wk
                        ).reshape(b, h, ww, c_out)
    if variant == "nine_dots":
        taps = w.reshape(9, c_in, c_out)

        def fn():
            acc = None
            for t, sl in enumerate(_slices(x)):
                p = (sl.reshape(b * h * ww, c_in) @ taps[t]).float()
                acc = p if acc is None else acc + p
            return acc.reshape(b, h, ww, c_out).to(torch.bfloat16)
        return fn
    raise ValueError(f"conv_probe: unknown variant {variant!r}")


def run(variant: str, b: int, h: int, c_in: int, c_out: int, k: int = 8,
        device="cuda") -> dict:
    """Time one variant at one shape and print its JSON line."""
    device = torch.device(device)
    x, w = probe_inputs(b, h, c_in, c_out, device)
    fn = variant_fn(variant, x, w)
    with torch.no_grad():
        ms = (cuda_ms if device.type == "cuda" else host_ms)(fn, k)
    macs = b * h * h * 9 * c_in * c_out
    rec = {"variant": variant, "shape": f"{b}x{h}^2x{c_in}->{c_out}", "ms": ms,
           "tf_s": 2 * macs / (ms * 1e-3) / 1e12}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32, help="frames a shape (the JAX probe's 32)")
    ap.add_argument("--hdiv", type=int, default=1, help="divide each shape's H=W by this")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("conv_probe runs on the CUDA device by default and none is "
                           "available; pass --device cpu")
    print(json.dumps(device_info(dev)), flush=True)
    return [run(v, args.batch, h // args.hdiv, ci, co, args.k, dev)
            for _, h, ci, co in SHAPES for v in VARIANTS]


if __name__ == "__main__":
    main()
