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

With ``--s2d 1`` it times the space-to-depth forward's stages instead
(``kernels/unet_s2d.py``'s ``encoder``, ``inject`` + ``bottleneck`` and
``decoder`` at the schedule that ``unet_apply_s2d`` infers, printed first
as ``{"schedule"}``: "s2d_encoder", "s2d_bottleneck", "s2d_decoder"); with
``--s2d_pieces 1`` each of its decoder's levels (``up_level``) and its
output conv (``outc``) alone, ``{"stage", "ms"}``.

  python -m videoseal_tpu_torch.evals.unet_bench [--keys 32] [--dtype bfloat16]
      [--s2d 1 | --s2d_pieces 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..kernels import unet_s2d as us
from ..kernels.unet_fused import bottleneck, decoder, encoder, inject
from ..utils.timing import cuda_ms, device_info, host_ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=32)
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--s2d", type=int, default=0,
                    help="time the space-to-depth forward's stages instead")
    ap.add_argument("--s2d_pieces", type=int, default=0,
                    help="time each s2d decoder level separately")
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
    if args.s2d_pieces or args.s2d:
        with torch.no_grad():
            fn = _s2d_decoder_pieces if args.s2d_pieces else _s2d_stages
            return {**info, **fn(unet, x, emb, s, timer, args.k)}
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


def _schedule(unet, s: int) -> tuple:
    sch = us.schedule_for(unet, s)
    print(json.dumps({"schedule": sch}), flush=True)
    return sch


def _s2d_stages(unet, x, emb, s: int, timer, k: int) -> dict:
    """The s2d forward's encoder, bottleneck (injection included) and
    decoder, each on the stage before's output."""
    sch, n = _schedule(unet, s), x.shape[0]
    hiddens = us.encoder(unet, x, sch)
    lat = hiddens[-1]
    y_pre = us.inject(unet, lat, emb, sch[-1])
    y = us.bottleneck(unet, y_pre, sch[-1])
    rows = []
    for name, fn in (("s2d_encoder", lambda: us.encoder(unet, x, sch)),
                     ("s2d_bottleneck", lambda: us.bottleneck(
                         unet, us.inject(unet, lat, emb, sch[-1]), sch[-1])),
                     ("s2d_decoder", lambda: us.decoder(unet, y, hiddens[:-1] + [y_pre], sch))):
        ms = timer(fn, k)
        rows.append({"stage": name, "ms": ms, "per_key_us": ms * 1e3 / n})
        print(json.dumps(rows[-1]), flush=True)
    return {"schedule": sch, "stages": rows}


def _s2d_decoder_pieces(unet, x, emb, s: int, timer, k: int) -> dict:
    """Each up level of the s2d decoder on the level before's output and
    its skip, then the output conv."""
    sch = _schedule(unet, s)
    hiddens = us.encoder(unet, x, sch)
    y_pre = us.inject(unet, hiddens[-1], emb, sch[-1])
    skips = hiddens[:-1] + [y_pre]
    cur = us.bottleneck(unet, y_pre, sch[-1])
    rows = []
    for i in range(len(unet.ups)):
        skip = skips[-1 - i]
        ms = timer(lambda: us.up_level(unet, i, cur, skip, sch), k)
        rows.append({"stage": f"s2d_up{i}", "ms": ms})
        print(json.dumps(rows[-1]), flush=True)
        cur = us.up_level(unet, i, cur, skip, sch)
    rows.append({"stage": "s2d_outc", "ms": timer(lambda: us.outc(unet, cur, sch), k)})
    print(json.dumps(rows[-1]), flush=True)
    return {"schedule": sch, "stages": rows}


if __name__ == "__main__":
    main()
