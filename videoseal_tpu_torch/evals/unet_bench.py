"""Per-stage timing of the serving UNet, counterpart of
``videoseal_tpu/evals/unet_bench.py``.

Times the stages that ``kernels/unet_fused.unet_apply_fused`` chains, its
encoder, bottleneck (the message injection and the bottleneck's blocks)
and decoder, at the serving shapes (32 key frames at the card's processing
size) on the card's folded weights, which every stage reads through
``fused_params`` as serving reads them. Each stage runs `k` calls back to
back after a warm-up, between CUDA events on the card
(``utils/timing.cuda_ms``), on the host clock on the CPU. Prints a line
naming the device, then one JSON line per stage, ``{"stage", "ms",
"per_key_us"}``.

  python -m videoseal_tpu_torch.evals.unet_bench [--keys 32] [--dtype bfloat16]

The JAX tool's ``--s2d`` and ``--s2d_pieces`` modes time its space-to-depth
forward (``kernels/unet_s2d.py``), a TPU layout with no counterpart here.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels.unet_fused import bottleneck, decoder, encoder, inject
from ..utils.timing import cuda_ms, device_info, host_ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=32)
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.cfg import load

    model = load(args.card, device=args.device).with_dtype(args.dtype)
    unet, dev = model.embedder.unet, model.device
    dtype, s, n = getattr(torch, args.dtype), model.cfg.img_size, args.keys
    # the JAX tool's inputs: x in [-1, 1] as the encoder sees it, and a
    # normal embedding in place of the message table's
    g = torch.Generator(device=dev).manual_seed(0)
    c = 1 if model.cfg.yuv else 3
    x = (torch.rand((n, s, s, c), generator=g, device=dev) * 2 - 1).to(dtype)
    emb = torch.randn((n, unet.msg_processor.hidden_size), generator=g, device=dev).to(dtype)
    timer = cuda_ms if dev.type == "cuda" else host_ms
    info = device_info(dev)
    print(json.dumps(info), flush=True)
    rows = []
    with torch.no_grad():
        hiddens = encoder(unet, x)
        lat = hiddens[-1]
        skips = hiddens[:-1] + [inject(unet, lat, emb)]
        y = bottleneck(unet, skips[-1])
        for name, fn in (("encoder", lambda: encoder(unet, x)),
                         ("bottleneck", lambda: bottleneck(unet, inject(unet, lat, emb))),
                         ("decoder", lambda: decoder(unet, y, skips))):
            ms = timer(fn, args.k)
            rows.append({"stage": name, "ms": ms, "per_key_us": ms * 1e3 / n})
            print(json.dumps(rows[-1]), flush=True)
    return {**info, "stages": rows}


if __name__ == "__main__":
    main()
