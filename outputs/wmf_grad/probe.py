"""How often chip_smoke.py phase 20's WmForger gradient check fails by
chance, and what the card leaves in the gradients whose CPU value is
exactly 0.

On one CUDA card, in one process:

  1. the CPU reference step (``chip_smoke._wmforger_step``) twice, which
     must agree bit for bit;
  2. `reps` card steps with nothing else run before them ("fresh");
  3. chip_smoke's kernels built, its `tools` phase run and the whole of
     phase 20's WmForger part (``_last_wmforger``: the two training runs,
     optimize, the card-against-CPU check) once, then `reps` card steps
     again ("after_tools").

Each card step is held against the CPU's by two measures: the one phase 20
used before (each tensor's max |card - CPU| over its own largest CPU value,
floored at 1e-12) and the one it uses now (``chip_smoke._grad_err``: over
the module's largest CPU gradient where the tensor's is exactly 0). One
JSON line a step; a summary on the last line, with the card's name and
power limit. Run from the repository's root:

  python3 outputs/wmf_grad/probe.py [--reps 30] > outputs/wmf_grad/log.txt
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def old_err(card: dict, cpu: dict) -> float:
    return max(float((card[n] - g).abs().max()) / max(float(g.abs().max()), 1e-12)
               for n, g in cpu.items())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    smi, _ = cs.phase_device()
    dev = torch.device("cuda", 0)
    from videoseal_tpu_torch.data.datasets import SyntheticImages
    img = torch.as_tensor(SyntheticImages(1, 256)[0][0])
    batch, draws = cs._wmforger_inputs()
    with cs.tf32_off():
        _, cpu, _ = cs._wmforger_step(torch.device("cpu"), img, batch, draws)
        _, cpu2, _ = cs._wmforger_step(torch.device("cpu"), img, batch, draws)
    cpu_equal = all(torch.equal(cpu[n], cpu2[n]) for n in cpu)
    zero = [n for n, g in cpu.items() if float(g.abs().max()) == 0.0]
    top = max(float(g.abs().max()) for g in cpu.values())
    print(json.dumps({"cpu_runs_equal": cpu_equal, "cpu_zero_grads": zero,
                      "module_largest": top}), flush=True)
    rows = []

    def card_steps(when: str) -> None:
        for i in range(args.reps):
            with cs.tf32_off():
                _, card, _ = cs._wmforger_step(dev, img, batch, draws)
            row = {"when": when, "rep": i, "old": old_err(card, cpu),
                   "new": cs._grad_err(card, cpu),
                   "zero_grads_card_max": {n: float(card[n].abs().max()) for n in zero}}
            rows.append(row)
            print(json.dumps(row), flush=True)

    card_steps("fresh")
    cs.phase_build()
    cs.phase_tools(dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            whole = {"grad_rel": cs._last_wmforger(dev, tmp, smi)["cpu"]["grad_rel"]}
        except AssertionError as e:
            whole = {"failed": str(e)}
    print(json.dumps({"last_wmforger": whole}), flush=True)
    card_steps("after_tools")
    summary = {"device": smi, "cpu_runs_equal": cpu_equal, "last_wmforger": whole}
    for when in ("fresh", "after_tools"):
        rs = [r for r in rows if r["when"] == when]
        summary[when] = {"steps": len(rs),
                         "old_fails": sum(r["old"] > cs.LAST_GRAD_RTOL for r in rs),
                         "new_fails": sum(r["new"] > cs.LAST_GRAD_RTOL for r in rs),
                         "new_max": max(r["new"] for r in rs),
                         "zero_grads_nonzero": sum(any(v > 0 for v in
                                                       r["zero_grads_card_max"].values())
                                                   for r in rs)}
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "wmf_grad.json"), "w") as f:
        json.dump({"summary": summary, "rows": rows}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
