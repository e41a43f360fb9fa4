"""Can the extractor's depthwise 7x7 run on the tensor cores? (perf tool, not
a serving path), counterpart of ``videoseal_tpu/evals/dw_mxu_probe.py``.

Per extractor stage geometry (ConvNeXt dims (96, 192, 384, 768), spatial
64/32/16/8 at the 256^2 processing size, depths (3, 3, 9, 3)), a chain of
`depth` zero-padded depthwise 7x7 convs (each output rounded to bf16 and fed
to the next) in four forms:

  vpu         the production tap loop: K8 (``kernels/convnext_probe.py``)
              in its ``dwconv_perdy`` variant, the depthwise form of K2's
              dwln (per-row partials, float32 sums, the bf16 sum without its
              bias), one launch a conv on the zero-padded input. The JAX
              probe's name is kept; on the card it is a counted CUDA launch
              of the port's own kernel;
  mxu_band    channels-first banded matmuls: the 7 dy-shifted row slabs
              concatenated along the contraction (K = 7*(W+6), N = W), one
              batched bf16 matmul a conv over the C channels;
              ``band_matrix`` B[c, dy*(W+6)+k, v] = wt[c, dy, k-v] is the
              zero-pad depthwise conv exactly;
  mxu_band_t  mxu_band plus the NHWC <-> NCHW relayouts a channels-last
              pipeline pays around each conv;
  mxu_diag    a dense 7x7 conv with a diagonal C -> C kernel (C times the
              MACs, on cuDNN's conv path).

Prints one JSON line a (stage, form), the JAX probe's keys: ``{"stage",
"c", "hw", "depth", "form", "ms", "gmac"}``; ms per stage (all its convs,
all frames).

  python -m videoseal_tpu_torch.evals.dw_mxu_probe [--frames 128] [--k 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import convnext_probe as cp
from ..kernels.convnext_probe import convnext_probe
from ..utils.timing import cuda_ms, device_info, host_ms

# (C, H=W, depth) per extractor stage at the 256^2 processing size
STAGES = [(96, 64, 3), (192, 32, 3), (384, 16, 9), (768, 8, 3)]


def band_matrix(wt: np.ndarray, w: int) -> np.ndarray:
    """wt (C, 7, 7) tap weights -> B (C, 7*(w+6), w) with
    B[c, dy*(w+6)+k, v] = wt[c, dy, k-v] for 0 <= k-v <= 6 (zero-pad conv:
    the input is padded by 3 in W, so output column v contracts padded
    columns v..v+6)."""
    c = wt.shape[0]
    b = np.zeros((c, 7 * (w + 6), w), wt.dtype)
    for dy in range(7):
        for v in range(w):
            b[:, dy * (w + 6) + v:dy * (w + 6) + v + 7, v] = wt[:, dy, :]
    return b


def stage_inputs(c: int, hw: int, frames: int, rng: np.random.Generator, device) -> dict:
    """The JAX probe's draws for one stage: x ~ N(0, 1) (F, H, W, C) bf16
    and tap weights wt ~ N(0, 0.1) (C, 7, 7) f32; then each form's operand
    and K8's parameters (the probe's, dw replaced by wt)."""
    x = torch.as_tensor(rng.normal(0, 1, (frames, hw, hw, c)), dtype=torch.float32,
                        device=device).to(torch.bfloat16)
    wt = rng.normal(0, 0.1, (c, 7, 7)).astype(np.float32)
    _, p = cp.probe_inputs(1, 1, 1, c, device)
    p["dw"] = torch.as_tensor(wt.reshape(c, 49).T.copy(), device=device)
    dense = np.zeros((c, c, 7, 7), np.float32)
    dense[np.arange(c), np.arange(c)] = wt
    return {"x": x, "wt": wt, "k8": p,
            "band": torch.as_tensor(band_matrix(wt, hw), device=device).to(torch.bfloat16),
            "diag": torch.as_tensor(dense, device=device).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)}


def _band_core(xcf: torch.Tensor, bm: torch.Tensor, h: int) -> torch.Tensor:
    """xcf (F, C, H+6, W+6) channels-first, zero-padded -> (F, C, H, W) bf16."""
    xcat = torch.cat([xcf[:, :, dy:dy + h] for dy in range(7)], dim=-1)   # (F, C, H, 7(W+6))
    return torch.einsum("fchk,ckv->fchv", xcat, bm)


def forms(inp: dict, depth: int) -> dict:
    """name -> fn() of the chained depthwise convs on inp["x"] (F, H, W, C)."""
    x, p, bm, dk = inp["x"], inp["k8"], inp["band"], inp["diag"]
    h = x.shape[1]

    def vpu():
        y = x
        for _ in range(depth):
            y = convnext_probe(F.pad(y, (0, 0, 3, 3, 3, 3)), p, "dwconv_perdy")
        return y

    def mxu_band():
        y = x.permute(0, 3, 1, 2)
        for _ in range(depth):
            y = _band_core(F.pad(y, (3, 3, 3, 3)), bm, h)
        return y

    def mxu_band_t():
        y = x
        for _ in range(depth):
            y = _band_core(F.pad(y.permute(0, 3, 1, 2), (3, 3, 3, 3)), bm, h).permute(0, 2, 3, 1)
        return y

    def mxu_diag():
        y = x.permute(0, 3, 1, 2)
        for _ in range(depth):
            y = F.conv2d(y, dk, padding=3)
        return y.permute(0, 2, 3, 1)

    return {"vpu": vpu, "mxu_band": mxu_band, "mxu_band_t": mxu_band_t, "mxu_diag": mxu_diag}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--stages", default="0,1,2,3", help="the stages to time, by index")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dw_mxu_probe runs on the CUDA device by default and none is "
                           "available; pass --device cpu")
    print(json.dumps(device_info(dev)), flush=True)
    timer = cuda_ms if dev.type == "cuda" else host_ms
    want = {int(i) for i in args.stages.split(",")}
    rng = np.random.default_rng(0)
    rows = []
    for ci, (c, hw, depth) in enumerate(STAGES):
        inp = stage_inputs(c, hw, args.frames, rng, dev)   # every stage draws, as in JAX
        if ci not in want:
            continue
        with torch.no_grad():
            for name, fn in forms(inp, depth).items():
                rows.append({"stage": ci, "c": c, "hw": hw, "depth": depth, "form": name,
                             "ms": timer(fn, args.k),
                             "gmac": depth * args.frames * 49 * c * hw * hw / 1e9})
                print(json.dumps(rows[-1]), flush=True)
        del inp
    return rows


if __name__ == "__main__":
    main()
