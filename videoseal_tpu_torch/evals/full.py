"""Full robustness and quality evaluation, counterpart of
``videoseal_tpu/evals/full.py``.

Per sample: embed -> quality (PSNR, SSIM, MS-SSIM, L-inf, and LPIPS with
AlexNet, else VGG, where converted weights are on disk:
``losses/lpips.build``; NaN otherwise) -> for every (attack, strength) of the grid:
attack the watermarked frames, detect, and score bit accuracy, p-value,
log10 p-value and capacity (plus the localization columns for a pixelwise
extractor, VMAF and BD-rate for video where an ffmpeg with libvmaf exists)
-> rows -> metrics.csv. Frames stay float32 on the model's device through
the attacks. Times come from CUDA events on the card and from the host
clock on the CPU; the row's ``timer`` column says which, and
``attack_time`` sits beside ``extract_time``.

  python -m videoseal_tpu_torch.evals.full --card videoseal_1.0 --is_video 0
  python -m videoseal_tpu_torch.evals.full --device cpu

The samples are a folder's images (or clips, with --is_video) through
``data/datasets.iter_samples`` with --dataset, else procedural synthetic
images (``synthetic_samples``).
"""

from __future__ import annotations

import argparse
import csv
import math
import os

import numpy as np
import torch

from ..utils.timing import timed


def write_csv(path: str, rows: list[dict]) -> None:
    """Rows to CSV, the columns in the order they first appear, NaN and
    missing values empty."""
    cols = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, restval="")
        w.writeheader()
        for r in rows:
            w.writerow({k: "" if isinstance(v, float) and math.isnan(v) else v
                        for k, v in r.items()})


def _vmaf_columns(imgs: np.ndarray, imgs_w: np.ndarray, si: int, bdrate: bool,
                  bdrate_crfs, verbose: bool) -> dict:
    """VMAF of the watermarked frames and, with bdrate, the Bjontegaard
    rate over a CRF sweep (watermarked against original rate/VMAF curves)."""
    from ..ops import metrics as M
    from .vmaf import vmaf_on_tensor

    out = {"vmaf": vmaf_on_tensor(imgs, imgs_w)}
    if not bdrate:
        return out
    r1, v1, r2, v2 = [], [], [], []
    for crf in bdrate_crfs:
        s, aux = vmaf_on_tensor(imgs, return_aux=True, crf=crf)
        r1.append(aux["bps2"])
        v1.append(s)
        s, aux = vmaf_on_tensor(imgs_w, return_aux=True, crf=crf)
        r2.append(aux["bps2"])
        v2.append(s)
    if any(x is None for x in v1 + v2):
        if verbose:
            print(f"eval: BD-rate skipped for sample {si} "
                  "(a VMAF run in the CRF sweep returned None)")
        return out
    out.update({"r1": "_".join(f"{x:.4g}" for x in r1),
                "vmaf1": "_".join(f"{x:.4g}" for x in v1),
                "r2": "_".join(f"{x:.4g}" for x in r2),
                "vmaf2": "_".join(f"{x:.4g}" for x in v2),
                "bd_rate": float(M.bd_rate(r1, v1, r2, v2))})
    return out


def _lpips_fn():
    """The eval-time LPIPS: AlexNet's (the reference's eval), else VGG's,
    from ``$VIDEOSEAL_TPU_WEIGHTS``; (fn or None, the first missing file's
    message)."""
    from ..losses import lpips as L

    missing = None
    for name in ("lpips_alex", "lpips"):
        try:
            return L.build(name, None), None
        except FileNotFoundError as e:
            missing = missing or str(e)
    return None, missing


def evaluate(model, samples, is_video: bool = False, validation_augs=None,
             aggregation: str = "avg", out_csv: str | None = None,
             max_samples: int | None = None, verbose: bool = True,
             bdrate: bool = True, bdrate_crfs=(28, 34, 40, 46)) -> list[dict]:
    """samples: iterable of (F|B, H, W, 3) float frames in [0, 1] (numpy
    arrays or tensors). Returns one dict per (sample, attack, strength);
    optionally writes them to `out_csv`."""
    from ..augmentation.validation import get_validation_augs
    from ..models.videoseal import aggregate_message
    from ..ops import metrics as M
    from .vmaf import vmaf_available

    if validation_augs is None:
        validation_augs = get_validation_augs(is_video)
    lpips, missing = _lpips_fn()
    if lpips is None and verbose:
        print(f"eval: LPIPS column NaN: {missing}")
    dev = model.device
    timer = "cuda_events" if dev.type == "cuda" else "host_clock"

    rows = []
    for si, imgs in enumerate(samples):
        if max_samples is not None and si >= max_samples:
            break
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
        outputs, embed_time = timed(lambda: model.embed(imgs, is_video=is_video), dev)
        imgs_w, msgs = outputs["imgs_w"], outputs["msgs"]
        with torch.no_grad():
            lp = float(lpips(2 * imgs_w - 1, 2 * imgs - 1)) if lpips is not None else math.nan
        base = {
            "sample": si,
            "embed_time": embed_time,
            "psnr": float(M.psnr(imgs_w, imgs, is_video=is_video).mean()),
            "ssim": float(M.ssim(imgs_w, imgs).mean()),
            "msssim": float(M.ms_ssim(imgs_w, imgs).mean())
            if min(imgs.shape[-3:-1]) > 160 else float("nan"),
            "linf": float(M.linf(imgs_w, imgs)),
            "lpips": lp,
        }
        if is_video:
            if not vmaf_available():
                if verbose and si == 0:
                    print("eval: VMAF/BD-rate columns skipped (no ffmpeg with libvmaf on PATH)")
            else:
                base.update(_vmaf_columns(imgs.cpu().numpy(), imgs_w.cpu().numpy(), si,
                                          bdrate, bdrate_crfs, verbose))

        mask = torch.ones_like(imgs_w[..., :1])
        for aug, strengths in validation_augs:
            for strength in strengths:
                (imgs_att, _), attack_time = timed(
                    lambda: aug.apply_strength(imgs_w, mask, strength), dev)
                preds, extract_time = timed(
                    lambda: model.detect(imgs_att, is_video=is_video)["preds"], dev)
                if is_video:
                    if preds.dim() == 4:
                        preds = preds.mean(dim=(1, 2))
                    decoded = aggregate_message(preds, aggregation)   # (1, nbits)
                    bit_acc = float(((decoded > 0.5) == (msgs[:1] > 0.5)).float().mean())
                else:
                    bit_acc = float(M.bit_accuracy(preds[..., 1:], msgs).mean())
                loc = {}
                if preds.dim() == 4:   # pixelwise extractor: localization metrics
                    det = preds[..., 0:1]
                    tgt = torch.ones_like(det)
                    loc = {"iou1": float(M.iou(det, tgt, label=1).mean()),
                           "acc": float(M.accuracy(det, tgt).mean()),
                           "bit_acc_1msg": float(M.bit_accuracy_1msg(preds[..., 1:],
                                                                     msgs).mean())}
                pv = float(M.pvalue(np.asarray([bit_acc]), model.nbits)[0])
                row = dict(base)
                row.update({
                    "aug": repr(aug), "strength": str(strength),
                    "bit_acc": bit_acc, "pvalue": pv,
                    "log10_pvalue": math.log10(max(pv, 1e-300)),
                    "capacity": float(M.capacity(torch.tensor([bit_acc]), model.nbits)[0]),
                    "extract_time": extract_time,
                    **loc,
                    "attack_time": attack_time,
                    "timer": timer,
                })
                rows.append(row)
                if verbose:
                    print(f"[{si}] {row['aug']}@{strength}: "
                          f"bit_acc={bit_acc:.3f} psnr={base['psnr']:.2f}")
    if out_csv:
        write_csv(out_csv, rows)
        if verbose:
            print(f"wrote {out_csv} ({len(rows)} rows)")
    return rows


def synthetic_samples(n: int, shape=(4, 256, 256, 3), seed: int = 0):
    """Procedural photo-like samples (gradients, blocky texture, waves):
    the JAX package's, bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        b, h, w, c = shape
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([yy / h, xx / w, (xx + yy) / (h + w)], -1)[None]
        tex = rng.normal(0, 0.08, (b, h // 8, w // 8, c)).astype(np.float32)
        tex = np.repeat(np.repeat(tex, 8, 1), 8, 2)
        phase = rng.uniform(0, 2 * np.pi, (b, 1, 1, 1)).astype(np.float32)
        waves = 0.1 * np.sin(xx[None, ..., None] / rng.uniform(3, 17) + phase)
        yield np.clip(base + tex + waves, 0, 1).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--card", default="videoseal_1.0")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--dataset", default=None,
                    help="a folder of images (of videos with --is_video 1)")
    ap.add_argument("--is_video", type=int, default=0)
    ap.add_argument("--num_samples", type=int, default=2)
    ap.add_argument("--output_dir", default="outputs")
    ap.add_argument("--scaling_w", type=float, default=None)
    ap.add_argument("--videoseal_step_size", type=int, default=None)
    ap.add_argument("--video_aggregation", default="avg")
    ap.add_argument("--only_identity", type=int, default=0)
    ap.add_argument("--bdrate", type=int, default=1,
                    help="BD-rate CRF sweep for video (needs an ffmpeg with libvmaf)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import dataclasses

    from ..augmentation.validation import get_validation_augs
    from ..utils.cfg import load

    model = load(args.card, checkpoint=args.checkpoint, device=args.device)
    if args.scaling_w is not None:
        model.scaling_w = args.scaling_w
    if args.videoseal_step_size is not None:
        model.cfg = dataclasses.replace(model.cfg, step_size=args.videoseal_step_size)
    if args.dataset:
        from ..data.datasets import iter_samples
        samples = iter_samples(args.dataset, is_video=bool(args.is_video))
    else:
        shape = (8, 256, 256, 3) if args.is_video else (4, 256, 256, 3)
        samples = synthetic_samples(args.num_samples, shape)
    os.makedirs(args.output_dir, exist_ok=True)
    augs = get_validation_augs(bool(args.is_video), only_identity=bool(args.only_identity))
    return evaluate(model, samples,
                    is_video=bool(args.is_video), validation_augs=augs,
                    aggregation=args.video_aggregation,
                    out_csv=os.path.join(args.output_dir, "metrics.csv"),
                    max_samples=args.num_samples, bdrate=bool(args.bdrate))


if __name__ == "__main__":
    main()
