"""K5 (``fused_jnd_delta``) at 128 frames of 1080p: does its time depend on
what the card ran just before it?

``chip_smoke.py``'s phase ``jnd`` times K5 on f32 frames twice: first with
``cuda_ms`` right after its u8 instance's timings (turns, split and geometry
sweep) and a ``torch.cuda.empty_cache()``, then in turns with its parent
after the plain version has run. This tool times the same f32 call in each
of those contexts, and in others that tell them apart (after an idle
pause, without the ``empty_cache``, after the f32 plain version), each call
between its own CUDA events, while ``nvidia-smi`` samples the card's SM and
memory clocks, power, temperature and clock-event reasons every 50 ms. It
prints one JSON line per context and writes every call's time and every
sample to ``--out``.

  python -m videoseal_tpu_torch.evals.k5_order [--calls 100] [--out chiprun_out/k5_order.json]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import time

import torch

from ..kernels import fused_blend as fb
from ..kernels import jnd_probe as jp
from ..utils.timing import device_info

# the clock-event reasons under their newer name, then their older one
QUERIES = tuple("timestamp,clocks.sm,clocks.mem,power.draw,temperature.gpu," + r
                for r in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"))
SW = 0.2


def _sampler(path: str) -> subprocess.Popen:
    """nvidia-smi's query every 50 ms into `path`, until terminated; the
    older field name where the newer one is refused."""
    for query in QUERIES:
        with open(path, "w") as out:
            proc = subprocess.Popen(["nvidia-smi", f"--query-gpu={query}",
                                     "--format=csv,noheader", "-lms", "50"], stdout=out,
                                    stderr=subprocess.STDOUT)
        time.sleep(1)
        if proc.poll() is None:
            return proc
    return proc


def _samples(path: str) -> list[tuple]:
    """(epoch seconds, SM MHz, memory MHz, W, deg C, reasons) of each
    sample."""
    out = []
    with open(path) as f:
        for ln in f:
            p = [s.strip() for s in ln.split(",")]
            try:
                t = datetime.datetime.strptime(p[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                out.append((t, float(p[1].split()[0]), float(p[2].split()[0]),
                            float(p[3].split()[0]), float(p[4]), p[5]))
            except (ValueError, IndexError):
                continue
    return out


def _timed(fn, calls: int) -> list[float]:
    """Each of `calls` back-to-back calls of fn between its own CUDA
    events, in ms."""
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(calls)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "k5_order.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k5_order times K5 on a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    print(device_info(0)["nvidia_smi"], flush=True)
    u8, pred = jp.probe_inputs(args.frames, 1080, 1920, torch.uint8, dev, seed=1)
    f32 = torch.rand(u8.shape, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    k5_f32 = lambda: fb.fused_jnd_delta(f32, pred, SW)
    for fn in (k5_f32, lambda: fb.fused_jnd_delta(u8, pred, SW),
               lambda: jp.jnd_probe(u8, pred, SW, "full_nosqrt", 8)):
        fn()   # the kernels' first calls: the library's build and load
    torch.cuda.synchronize()

    def u8_load() -> None:
        """What phase jnd runs on u8 frames before K5's f32 cuda_ms: K5,
        its plain version, the turns with the parent, the split and the
        geometry sweep."""
        for _ in range(11):
            fb.fused_jnd_delta(u8, pred, SW)
        for _ in range(4):
            fb.fused_jnd_delta_plain(u8, pred, SW)
        for _ in range(22):
            jp.jnd_probe(u8, pred, SW, "full_nosqrt", 8)
            fb.fused_jnd_delta(u8, pred, SW)
        for mode in jp.SPLIT_MODES:
            jp.jnd_probe_plain(u8, pred, SW, mode)
            for _ in range(11):
                jp.k5_split(u8, pred, SW, mode)
        for rows in (16, 32, 64):
            for band_max in (2048, 1024):
                for _ in range(12):
                    fb._delta_cuda(u8, pred, SW, rows=rows, band_max=band_max)
        torch.cuda.synchronize()

    def f32_plain() -> None:
        for _ in range(4):
            fb.fused_jnd_delta_plain(f32, pred, SW)
        torch.cuda.synchronize()

    def idle() -> None:
        torch.cuda.empty_cache()
        time.sleep(5)

    # (name, what runs before the timed calls); phase jnd's two contexts
    # are after_u8_sweep and after_plain
    contexts = [
        ("idle", idle),
        ("again", lambda: None),
        ("after_u8_sweep", lambda: (u8_load(), torch.cuda.empty_cache())),
        ("after_u8_sweep_kept_cache", u8_load),
        ("after_u8_sweep_idle", lambda: (u8_load(), idle())),
        ("after_plain", f32_plain),
        ("after_u8_sweep_then_plain", lambda: (u8_load(), torch.cuda.empty_cache(),
                                               f32_plain())),
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    smi_path = os.path.abspath(args.out) + ".smi.csv"
    sampler = _sampler(smi_path)
    recs = []
    try:
        for name, before in contexts:
            before()
            t0 = time.time()
            ms = _timed(k5_f32, args.calls)
            recs.append({"context": name, "t0": t0, "t1": time.time(), "ms": ms})
        time.sleep(0.2)
    finally:
        sampler.terminate()
        sampler.wait()
    samples = _samples(smi_path)
    for r in recs:
        win = [s for s in samples if r["t0"] - 0.05 <= s[0] <= r["t1"] + 0.05]
        ms = r["ms"]
        line = {"context": r["context"], "mean_ms": sum(ms) / len(ms), "min_ms": min(ms),
                "max_ms": max(ms), "first5_ms": sum(ms[:5]) / 5, "last5_ms": sum(ms[-5:]) / 5,
                "samples": len(win)}
        if win:
            line.update(sm_mhz=[min(s[1] for s in win), max(s[1] for s in win)],
                        mem_mhz=[min(s[2] for s in win), max(s[2] for s in win)],
                        power_w=[min(s[3] for s in win), max(s[3] for s in win)],
                        temp_c=[min(s[4] for s in win), max(s[4] for s in win)],
                        reasons=sorted({s[5] for s in win}))
        r.update(summary=line)
        print(json.dumps(line), flush=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "contexts": recs,
                   "samples": samples}, f)
    return recs


if __name__ == "__main__":
    main()
