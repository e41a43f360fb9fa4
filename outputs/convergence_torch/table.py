"""The stage A trajectories of this folder beside the TPU's: for each
log.txt, the first logged step at which bit_acc (the log's windowed
median) reaches 0.6 / 0.75 / 0.9 / 0.98 / 1.0, bit_acc at a few steps, and
the last line's bit_acc and psnr; then, for runs of one start, the first
logged step at which two logs differ. "uniform init" is init_weights
before it drew flax's initializers (U(+-1/sqrt(fan_in)) weights and
biases), "lecun init" lecun_init.py's, "flax init" init_weights since: the
same draws as lecun_init.py's.

    python outputs/convergence_torch/table.py
"""

import json
import os

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
]
PAIRS = [           # two runs of one start: (name, run, run) by RUNS' names
    ("repeat a, b", "card, uniform init, seed 444, repeat a", "card, uniform init, seed 444, repeat b"),
    ("deterministic a, b", "card, uniform init, seed 444, deterministic a",
     "card, uniform init, seed 444, deterministic b"),
    ("lecun seed 444, both", "card, lecun init, seed 444", "card, lecun init, seed 444 (2nd)"),
    ("seed 444: lecun, flax init deterministic", "card, lecun init, seed 444 (2nd)",
     "card, flax init, seed 444, deterministic"),
]
MARKS = (0.6, 0.75, 0.9, 0.98, 1.0)
AT = (1000, 2000, 2490)


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


if __name__ == "__main__":
    main()
