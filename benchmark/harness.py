"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

Everything is found by name: the cell in ``workloads/<name>.json``, its
configuration in ``configs/<config>.json``, its request kind in
``traffic/<entry>.py`` and each metric in ``metrics/<name>.py``; the
metrics a cell reports are those `BENCHMARK.json` gives it.

A run is a closed loop with one client: each request takes a clip drawn
from the seed out of a pool made at set-up and kept on the device, and the
next message of a table drawn from the seed, calls the port's entry, and
waits until its outputs are ready; the next request follows at once. The
window measures `seconds` seconds of such requests. With tracing on, a
second window of the cell's `trace_seconds` runs under torch.profiler
after it. Then the program's state is freed and a sample of the window's
requests, drawn from the seed, is held against the plain float32
reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext

import torch

from . import program, trace, weights
from .reference import nets

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "videoseal_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def load_workload(name: str) -> dict:
    return dict(load_json("workloads", name), name=name)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def traffic(entry: str):
    return importlib.import_module(f"benchmark.traffic.{entry}")


def reader(metric: str):
    return importlib.import_module(f"benchmark.metrics.{metric}")


def metrics_of(cell: str, entries: list) -> list:
    """The manifest's metric entries that this cell reports."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def sub_seed(seed: int, k: int) -> int:
    """Independent generator seeds for the weights (0), the data (1) and the
    host's draws (2)."""
    return (int(seed) * 4 + k) % 2 ** 63


@dataclasses.dataclass
class Run:
    """What a run measured, handed to the metric readers."""
    workload: dict
    card: dict
    traffic: object
    setup_s: float = 0.0
    spans: list = dataclasses.field(default_factory=list)   # (submit, returned, done)
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    trace: trace.Trace | None = None
    readings: dict = dataclasses.field(default_factory=dict)
    correct: bool = False

    @property
    def window_s(self) -> float:
        return self.spans[-1][2] - self.spans[0][0] if self.spans else 0.0

    @property
    def traced_requests(self) -> int:
        return len(self.trace.requests) if self.trace else 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(tm, model, pool, msgs, workload, seconds, rng, keep=0, mark=False, run=None):
    """Closed-loop requests for `seconds`; returns the spans and a reservoir
    sample of `keep` requests: (clip index, message index, kept outputs)."""
    spans, sample = [], []
    end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < end:
        c, m = rng.randrange(len(pool)), i % msgs.shape[0]
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(trace.REQUEST) if mark else nullcontext():
                out = tm.call(model, pool[c], msgs[m:m + 1], workload)
                t1 = time.perf_counter()
                tm.finish(out)
        except (RuntimeError, ValueError):
            if run is not None:
                run.failed += 1
                if run.failed == 1:
                    traceback.print_exc()
            i += 1
            continue
        spans.append((t0, t1, time.perf_counter()))
        if len(sample) < keep:
            sample.append((c, m, tm.keep(out)))
        elif keep:
            j = rng.randrange(i + 1)   # reservoir: every request kept with one chance
            if j < keep:
                sample[j] = (c, m, tm.keep(out))
        del out
        i += 1
    if run is not None:
        run.attempted += i
    return spans, sample


def check(workload: dict, tm, sd, card, pool, msgs, sample, ops) -> dict:
    """The worst reading of each compared number over the sampled requests,
    one reference per distinct request."""
    readings: dict = {}
    groups: dict = {}
    for c, m, kept in sample:
        groups.setdefault(tm.ref_key(c, m), []).append((c, m, kept))
    for items in groups.values():
        c, m, _ = items[0]
        ref = tm.reference(sd, card, pool[c], msgs[m], workload, ops)
        for _, _, kept in items:
            for name, value in tm.compare(kept, ref, workload).items():
                value = value if value == value else float("inf")   # NaN fails
                readings[name] = max(readings.get(name, 0.0), value)
        del ref
    return readings


def passes(readings: dict, limits: dict) -> bool:
    """Every number the cell holds to a limit was read and lies within it."""
    return all(k in readings and readings[k] <= limits[k] for k in limits)


def prepare(workload: dict, config: dict, seed: int, device):
    """What a run draws from its seed: the weights, the pool of clips, the
    message table and the host's draws (clip choice, the sample)."""
    card = config["card"]
    tm = traffic(workload["entry"])
    sd = weights.draw(program.state_shapes(card), sub_seed(seed, 0), device,
                      getattr(torch, config["dtype"]))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    pool = [tm.inputs(workload, card, gen, device) for _ in range(workload["pool"])]
    msgs = torch.randint(0, 2, (workload["messages"], card["args"]["nbits"]), generator=gen,
                         device=device, dtype=torch.int32)
    return card, tm, sd, pool, msgs, random.Random(sub_seed(seed, 2))


def run_cell(workload: dict, config: dict, seed: int, seconds: float, traced: bool,
             device, t0: float | None = None, trace_dir: str | None = None) -> Run:
    """Set up, measure, trace (optionally), check."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    marks = [("start", time.perf_counter())]
    card, tm, sd, pool, msgs, rng = prepare(workload, config, seed, device)
    _sync(device)
    marks.append(("weights and pool", time.perf_counter()))
    run = Run(workload, card, tm)
    model = program.build(card, sd, device, config["dtype"])
    _sync(device)
    marks.append(("model", time.perf_counter()))
    for i in range(workload["warmup"]):
        tm.finish(tm.call(model, pool[i % len(pool)], msgs[i:i + 1], workload))
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t0
    print("set-up: before the cell %.3f s, " % (marks[0][1] - t0) + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:])), file=sys.stderr)
    run.spans, sample = window(tm, model, pool, msgs, workload, seconds, rng,
                               keep=workload["samples"], run=run)
    _sync(device)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    if traced:
        run.trace = traced_window(tm, model, pool, msgs, workload, rng, device, trace_dir)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.readings = check(workload, tm, sd, card, pool, msgs, sample, nets.Ops())
    run.correct = run.failed == 0 and bool(sample) and passes(run.readings, workload["limits"])
    return run


def traced_window(tm, model, pool, msgs, workload, rng, device, trace_dir):
    """A window of the cell's `trace_seconds` under torch.profiler; its
    Chrome trace and per-kernel table go to `trace_dir` (a temporary
    directory that is removed, unless given)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        window(tm, model, pool, msgs, workload, workload["trace_seconds"], rng, mark=True)
        _sync(device)
    keep = trace_dir is not None
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="bench-trace-")   # under TMPDIR
    try:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        sort = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
        with open(os.path.join(trace_dir, "kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=60, max_name_column_width=90))
        return trace.load(path)
    finally:
        if not keep:
            shutil.rmtree(trace_dir, ignore_errors=True)


def report(run: Run, entries: list, cell: str) -> dict:
    """{metric: {"value", "unit"}} of the entries this cell reports whose
    reader finds something to read."""
    out = {}
    for m in metrics_of(cell, entries):
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(args, t0: float) -> int:
    """The command line's run: returns the exit code; prints the result line
    only where the run reached its end on the card."""
    spec = manifest()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"benchmark: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    workload = load_workload(args.workload)
    config = load_json("configs", workload["config"])
    dev = torch.device("cuda", 0)
    run = run_cell(workload, config, args.seed, args.seconds, bool(args.trace), dev, t0,
                   trace_dir=args.trace_dir)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    entries = spec["per_layer"] if args.trace else spec["end_to_end"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": run.peak_bytes, "power": power_limit()}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": report(run, entries, args.workload), "device": device}
    if run.trace is not None:
        lo, hi = run.trace.window_us()
        device.update(busy_s=run.trace.busy_us() * 1e-6, window_s=(hi - lo) * 1e-6)
        result["breakdown"] = trace.breakdown(run.trace)
    limits = workload["limits"]
    # a reading that is not a finite number (a NaN reads as infinite) goes out as text
    shown = {k: v if math.isfinite(v) else str(v) for k, v in run.readings.items()}
    result["checks"] = {k: {"value": shown.get(k), "limit": limits[k]} for k in limits}
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
