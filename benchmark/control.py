"""The readings that the limits of `correct` are set from, for one cell:

* the program's: whole runs of the cell (set-up, a short window, the check)
  on many seeds, in one process so that the set-up is paid once;
* the control's: the reference with its convolutions' and dense layers'
  operands rounded to float8 e4m3 (`reference.nets.Fp8Ops`: the step below
  the configuration's bfloat16) put in the program's place, on the same
  inputs, as many requests as a run compares, held to the same numbers.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \
        --control_seeds 7,8,9 [--seconds 3]

One JSON line a seed, then one with each number's largest program reading
(the lower), smallest control reading (the upper), and the limit the cell
holds. Benchmark runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness
from .reference import nets


def control_readings(workload: dict, config: dict, seed: int, device) -> dict:
    """The numbers a run would read if the program's outputs were the
    lower-precision reference's, on the requests the seed draws."""
    card, tm, sd, pool, msgs, rng = harness.prepare(workload, config, seed, device)
    sample = []
    for i in range(workload["samples"]):
        c = rng.randrange(len(pool))
        ref = tm.reference(sd, card, pool[c], msgs[i], workload, nets.Fp8Ops())
        sample.append((c, i, tm.as_kept(ref, workload)))
    return harness.check(workload, tm, sd, card, pool, msgs, sample, nets.Ops())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="", help="the program's seeds, comma-separated")
    ap.add_argument("--control_seeds", default="", help="the control's seeds")
    ap.add_argument("--seconds", type=float, default=3.0, help="each program run's window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    workload = harness.load_workload(args.workload)
    config = harness.load_json("configs", workload["config"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for seed in seeds:
        run = harness.run_cell(workload, config, seed, args.seconds, False, dev)
        print(json.dumps({"kind": "program", "seed": seed, "correct": run.correct,
                          "requests": len(run.spans), "readings": run.readings}), flush=True)
        for k, v in run.readings.items():
            lower[k] = max(lower.get(k, 0.0), v)
    for seed in cseeds:
        readings = control_readings(workload, config, seed, dev)
        print(json.dumps({"kind": "control", "seed": seed, "readings": readings}), flush=True)
        for k, v in readings.items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "limits": workload["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
