"""The full robustness eval of a training checkpoint, counterpart of
``videoseal_tpu/tools/eval_checkpoint.py``: a train-state ``.npz`` (the
port's, or one the JAX package wrote) -> the card's embedder and extractor
with the flags' overrides and the trained weights -> a ``VideoSeal`` ->
``evals.full.evaluate`` over synthetic samples -> metrics.csv and the mean
bit accuracy per attack.

    python -m videoseal_tpu_torch.tools.eval_checkpoint \\
        --checkpoint outputs/checkpoint.npz --card videoseal_1.0 --nbits 32 \\
        --img_size 128 --scaling_w 0.4 --samples 4 --out_csv metrics.csv
"""

from __future__ import annotations

import argparse
import copy

import numpy as np


def load_trained_model(checkpoint: str, card: str | dict = "videoseal_1.0", nbits: int = 32,
                       img_size: int = 128, scaling_w: float = 0.4,
                       attenuation: str = "jnd_1_1", device="cuda"):
    """A train-state .npz -> the serving VideoSeal on `device`, built as
    train.py builds the modules (the card by name or file, or a card dict,
    with nbits, img_size, scaling_w and attenuation set)."""
    from ..models.videoseal import VideoSeal
    from ..utils.cfg import load_card

    c = copy.deepcopy(card if isinstance(card, dict) else load_card(card))
    c["args"].update(nbits=nbits, img_size_proc=img_size, scaling_w=scaling_w,
                     attenuation=attenuation)
    return VideoSeal.from_card(c, checkpoint=checkpoint, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--card", default="videoseal_1.0", help="a card's name or a card file")
    ap.add_argument("--nbits", type=int, default=32)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--scaling_w", type=float, default=0.4)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--sample_size", type=int, default=128)
    ap.add_argument("--out_csv", default="metrics.csv")
    ap.add_argument("--is_video", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data.datasets import SyntheticImages
    from ..evals.full import evaluate

    model = load_trained_model(args.checkpoint, args.card, args.nbits, args.img_size,
                               args.scaling_w, device=args.device)
    ds = SyntheticImages(args.samples, img_size=args.sample_size, seed=123)
    samples = [np.stack([ds[i][0]]) for i in range(args.samples)]
    rows = evaluate(model, samples, is_video=bool(args.is_video), out_csv=args.out_csv,
                    bdrate=False)
    agg: dict = {}
    for r in rows:
        agg.setdefault(f"{r['aug']}_{r['strength']}", []).append(r.get("bit_acc", float("nan")))
    print("== mean bit accuracy per attack ==")
    for k, v in agg.items():
        print(f"  {k}: {np.nanmean(v):.4f}")
    return rows


if __name__ == "__main__":
    main()
