"""Step-size sweep, counterpart of ``videoseal_tpu/evals/step_size_eval.py``.

Runs the subset video evaluation for each ``videoseal_step_size`` (the
model loaded anew for each step, as the JAX package rebuilds its jitted
functions) and writes one metrics CSV per step and a summary CSV (mean bit
accuracy, PSNR and embed time per step): the robustness/speed trade of
temporal watermark propagation.

  python -m videoseal_tpu_torch.evals.step_size_eval --card videoseal_1.0
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def sweep(load_model, step_sizes, num_samples: int, output_dir: str,
          shape=(16, 256, 256, 3)) -> list[dict]:
    """load_model() -> a fresh model; one summary row per step size."""
    from ..augmentation.validation import get_validation_augs_subset
    from .full import evaluate, synthetic_samples, write_csv

    os.makedirs(output_dir, exist_ok=True)
    summary = []
    for step in step_sizes:
        model = load_model()
        model.cfg = dataclasses.replace(model.cfg, step_size=step)
        rows = evaluate(model, synthetic_samples(num_samples, shape), is_video=True,
                        validation_augs=get_validation_augs_subset(True),
                        out_csv=os.path.join(output_dir, f"metrics_step{step}.csv"),
                        verbose=False)
        summary.append({"step_size": step,
                        **{k: float(np.mean([r[k] for r in rows]))
                           for k in ("bit_acc", "psnr", "embed_time")}})
        print(summary[-1])
    write_csv(os.path.join(output_dir, "summary.csv"), summary)
    print(f"wrote {output_dir}/summary.csv")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--step_sizes", default="1,2,4,8,16")
    ap.add_argument("--num_samples", type=int, default=2)
    ap.add_argument("--output_dir", default="outputs/step_size_eval")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.cfg import load

    return sweep(lambda: load(args.card, checkpoint=args.checkpoint, device=args.device),
                 [int(s) for s in args.step_sizes.split(",")], args.num_samples,
                 args.output_dir)


if __name__ == "__main__":
    main()
