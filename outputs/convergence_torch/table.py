"""The stage A trajectories of this folder beside the TPU's: for each
log.txt, the first logged step at which bit_acc (the log's windowed
median) reaches 0.6 / 0.75 / 0.9 / 0.98 / 1.0, bit_acc at a few steps, and
the last line's bit_acc and psnr; then, for runs of one start, the first
logged step at which two logs differ. "uniform init" is init_weights
before it drew flax's initializers (U(+-1/sqrt(fan_in)) weights and
biases), "lecun init" lecun_init.py's, "flax init" init_weights since: the
same draws as lecun_init.py's. "float32" and "bf16 operands" are
precision/run.sh's two arms (the trainer as it runs, and under
precision/bf16_ops.py); a 7,500-step run's last logged step is 7,490.

    python outputs/convergence_torch/table.py

With `stageB`, stage B's runs (docs/training.md:84-100, resumed from a
stage A) beside the TPU's: the median logged bit_acc and psnr over steps
10,000-11,990 (the convergence rule's window), the lowest bit_acc before
step 4,000 and the first logged step after it back at 0.95, and the last
line; then each robustness sweep's (metrics.csv, at --scaling_w 0.4 as
the TPU's; metrics_sw1.csv at 1.0 where run) mean bit_acc by attack, the
attack's parameters dropped, beside r2's, and the identity rows' psnr.

    python outputs/convergence_torch/table.py stageB
"""

import csv
import json
import os
import re
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
RUNS = [
    ("TPU r2 (JAX, lecun_normal)", "outputs/convergence_r2/stageA/log.txt"),
    ("TPU r4 (JAX, lecun_normal)", "outputs/convergence_r4/stageA/log.txt"),
    ("card, uniform init, seed 444", "outputs/convergence_torch/stageA/log.txt"),
    ("card, uniform init, seed 444, TF32 off", "outputs/convergence_torch/init_tf32/tf32off.log.txt"),
    ("card, uniform init, seed 0", "outputs/convergence_torch/seeds/uniform0.log.txt"),
    ("card, uniform init, seed 1", "outputs/convergence_torch/seeds/uniform1.log.txt"),
    ("card, lecun init, seed 444", "outputs/convergence_torch/stageA_lecun_init/log.txt"),
    ("card, lecun init, seed 444 (2nd)", "outputs/convergence_torch/init_tf32/lecun444.log.txt"),
    ("card, lecun init, seed 0", "outputs/convergence_torch/init_tf32/lecun0.log.txt"),
    ("card, lecun init, seed 1", "outputs/convergence_torch/seeds/lecun1.log.txt"),
    ("card, lecun init, seed 2", "outputs/convergence_torch/seeds/lecun2.log.txt"),
    ("card, uniform init, seed 444, repeat a", "outputs/convergence_torch/repeat/default_a.log.txt"),
    ("card, uniform init, seed 444, repeat b", "outputs/convergence_torch/repeat/default_b.log.txt"),
    ("card, uniform init, seed 444, deterministic a",
     "outputs/convergence_torch/repeat/det_a.log.txt"),
    ("card, uniform init, seed 444, deterministic b",
     "outputs/convergence_torch/repeat/det_b.log.txt"),
    ("card, flax init, seed 444, deterministic", "outputs/convergence_torch/flax_init/seed444.log.txt"),
    ("card, flax init, seed 0, deterministic", "outputs/convergence_torch/flax_init/seed0.log.txt"),
    ("card, flax init, seed 1, deterministic", "outputs/convergence_torch/flax_init/seed1.log.txt"),
    ("card, flax init, seed 2, deterministic", "outputs/convergence_torch/flax_init/seed2.log.txt"),
    ("card, flax init, seed 444 (the recipe)",
     "outputs/convergence_torch/flax_init/stageA/log.txt"),
] + [
    (f"card, flax init, seed {s}, deterministic, {arm}",
     f"outputs/convergence_torch/precision/{tag}_seed{s}.log.txt")
    for tag, arm in (("f32", "float32"), ("bf16", "bf16 operands"))
    for s in (444, 0, 1, 2)
] + [
    ("card, flax init, seed 444, deterministic, float32, 15,000",
     "outputs/convergence_torch/precision/f32_seed444_15000.log.txt"),
]
PAIRS = [           # two runs of one start: (name, run, run) by RUNS' names
    ("repeat a, b", "card, uniform init, seed 444, repeat a", "card, uniform init, seed 444, repeat b"),
    ("deterministic a, b", "card, uniform init, seed 444, deterministic a",
     "card, uniform init, seed 444, deterministic b"),
    ("lecun seed 444, both", "card, lecun init, seed 444", "card, lecun init, seed 444 (2nd)"),
    ("seed 444: lecun, flax init deterministic", "card, lecun init, seed 444 (2nd)",
     "card, flax init, seed 444, deterministic"),
] + [
    pair for s in (444, 0, 1, 2) for pair in (
        (f"seed {s}: flax_init 3,000, float32 7,500", f"card, flax init, seed {s}, deterministic",
         f"card, flax init, seed {s}, deterministic, float32"),
        (f"seed {s}: float32, bf16 operands", f"card, flax init, seed {s}, deterministic, float32",
         f"card, flax init, seed {s}, deterministic, bf16 operands"))
] + [
    ("seed 444: float32 7,500, 15,000", "card, flax init, seed 444, deterministic, float32",
     "card, flax init, seed 444, deterministic, float32, 15,000"),
]
MARKS = (0.6, 0.75, 0.9, 0.98, 1.0)
AT = (1000, 2000, 2490, 5000, 7490)    # 7490: the last logged step of 7,500


STAGE_B = [
    ("TPU r2 (JAX; stage A to ~8,870, the discriminator on at 2,130)",
     "outputs/convergence_r2/stageB/log.txt", "outputs/convergence_r2/stageB/metrics.csv"),
    ("TPU r4 (JAX; stage A to 15,000, the discriminator on from 0)",
     "outputs/convergence_r4/stageB/log.txt", None),
] + [
    (f"card, stage-B seed {s} (float32 seed-444 stage A to 15,000, the discriminator on from 0)",
     f"outputs/convergence_torch/stageB/seed{s}.log.txt",
     f"outputs/convergence_torch/stageB/seed{s}.metrics.csv")
    for s in (444, 0)
]
WINDOW, DIP_BEFORE, BACK_AT = (10000, 11990), 4000, 0.95


def load(path):
    return [json.loads(ln) for ln in open(os.path.join(ROOT, path))]


def main():
    print("| run | steps to " + " / ".join(map(str, MARKS)) + " | bit_acc at "
          + " / ".join(map(str, AT)) + " | last step: bit_acc, psnr |")
    print("|---|---|---|---|")
    for name, path in RUNS:
        rows = load(path)
        by_step = {r["step"]: r for r in rows}
        marks = [next((str(r["step"]) for r in rows if r["bit_acc"] >= m), "-") for m in MARKS]
        at = [f"{by_step[s]['bit_acc']:.3f}" if s in by_step else "-" for s in AT]
        last = rows[-1]
        print(f"| {name} | {' / '.join(marks)} | {' / '.join(at)} | {last['step']}: "
              f"{last['bit_acc']:.4f}, {last['psnr']:.2f} dB |")
    paths = dict(RUNS)
    print("\n| one start | first logged step that differs | last step both logged |")
    print("|---|---|---|")
    for name, a, b in PAIRS:
        ra, rb = load(paths[a]), load(paths[b])
        both = list(zip(ra, rb))
        first = next((str(x["step"]) for x, y in both if x != y), "none")
        print(f"| {name} | {first} | {both[-1][0]['step']} |")


def stage_b():
    print(f"| run | median bit_acc, psnr over {WINDOW[0]:,}-{WINDOW[1]:,} | lowest bit_acc "
          f"before {DIP_BEFORE:,} | back to {BACK_AT} | last step: bit_acc, psnr |")
    print("|---|---|---|---|---|")
    sweeps = []
    for name, path, sweep in STAGE_B:
        if not os.path.exists(os.path.join(ROOT, path)):
            print(f"| {name} | not run | | | |")
            continue
        rows = load(path)
        win = [r for r in rows if WINDOW[0] <= r["step"] <= WINDOW[1]]
        med = (lambda k: statistics.median(r[k] for r in win))
        low = min((r for r in rows if r["step"] < DIP_BEFORE), key=lambda r: r["bit_acc"])
        back = next((str(r["step"]) for r in rows if r["step"] > low["step"]
                     and r["bit_acc"] >= BACK_AT), "-")
        cell = f"{med('bit_acc'):.4f}, {med('psnr'):.2f} dB ({len(win)} lines)" if win else "-"
        last = rows[-1]
        print(f"| {name} | {cell} | {low['bit_acc']:.4f} at {low['step']} | {back} | "
              f"{last['step']}: {last['bit_acc']:.4f}, {last['psnr']:.2f} dB |")
        short = name.split(" (")[0]
        for label, csv_path in ((short, sweep), (f"{short} at scaling_w 1.0",
                                                 sweep and sweep.replace(".csv", "_sw1.csv"))):
            if csv_path and os.path.exists(os.path.join(ROOT, csv_path)):
                sweeps.append((label, csv_path))
    if not sweeps:
        return
    means = []
    for _, sweep in sweeps:
        acc: dict = {}
        for r in csv.DictReader(open(os.path.join(ROOT, sweep))):
            acc.setdefault(re.sub(r"\([^)]*\)", "", r["aug"]), []).append(float(r["bit_acc"]))
        means.append({k: (sum(v) / len(v), len(v)) for k, v in acc.items()})
    print("\n| attack (rows) | " + " | ".join(n for n, _ in sweeps) + " |")
    print("|---|" + "---|" * len(sweeps))
    for aug in dict.fromkeys(k for m in means for k in m):
        cells = [f"{m[aug][0]:.4f} ({m[aug][1]})" if aug in m else "-" for m in means]
        print(f"| {aug} | " + " | ".join(cells) + " |")
    psnr = [[float(r["psnr"]) for r in csv.DictReader(open(os.path.join(ROOT, p)))
             if r["aug"] == "Identity()"] for _, p in sweeps]
    print("| identity psnr, dB | " + " | ".join(f"{min(v):.2f}-{max(v):.2f}" for v in psnr)
          + " |")


if __name__ == "__main__":
    stage_b() if sys.argv[1:] == ["stageB"] else main()
