"""FLOPs and parameter accounting, counterpart of ``videoseal_tpu/evals/flops.py``.

Parameter counts are the JAX package's (its variables hold the BatchNorm
statistics, so the float buffers count here too). GFLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` over the embed and detect
pipelines of a CPU copy of the model, where the kernels' plain versions run
(the kernels' ctypes launches on the card are invisible to it). It counts
the convolutions and matmuls PyTorch dispatches, not XLA's cost analysis of
a compiled program; each row names its counter.

  python -m videoseal_tpu_torch.evals.flops --card videoseal_1.0
"""

from __future__ import annotations

import argparse
import json

import torch

COUNTER = "torch.utils.flop_counter.FlopCounterMode, CPU plain versions"


def count_params(module: torch.nn.Module) -> int:
    """Parameters plus float buffers (the BatchNorm statistics)."""
    return (sum(p.numel() for p in module.parameters())
            + sum(b.numel() for b in module.buffers() if b.is_floating_point()))


def cost_analysis(model, frames_shape=(8, 256, 256, 3)) -> dict:
    """GFLOPs of one embed (video, full-resolution JND) and one detect of
    float frames, counted on the CPU, and the two parameter counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.videoseal import detect_pipeline, embed_pipeline

    if model.device.type != "cpu":
        raise ValueError("cost_analysis counts the plain versions: pass a model on the CPU")
    cfg = model.cfg
    frames = torch.zeros(frames_shape)
    msgs = torch.zeros((1, cfg.nbits), dtype=torch.int32)
    calls = {
        "embed": lambda: embed_pipeline(model.embedder, model.attenuation, cfg, frames, msgs,
                                        0.2, 1.0, is_video=True, lowres_attenuation=False),
        "extract": lambda: detect_pipeline(model.extractor, cfg, frames),
    }
    out = {"counter": COUNTER}
    for name, fn in calls.items():
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn()
        flops = counter.get_total_flops()
        out[f"{name}_gflops"] = round(flops / 1e9, 3)
        out[f"{name}_gflops_per_frame"] = round(flops / 1e9 / frames_shape[0], 3)
    out["embedder_params_M"] = round(count_params(model.embedder) / 1e6, 3)
    out["extractor_params_M"] = round(count_params(model.extractor) / 1e6, 3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the model is built; the FLOPs are counted on a CPU copy")
    args = ap.parse_args(argv)
    from ..utils.cfg import load

    model = load(args.card, device=args.device)
    if model.device.type != "cpu":
        model = load(args.card, device="cpu")
    row = {"card": args.card, **cost_analysis(model, (args.frames, 256, 256, 3))}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
