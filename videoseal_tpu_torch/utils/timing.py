"""Kernel and stage timing on the card, the port's counterpart of
``videoseal_tpu/evals/stage_bench.py::time_stage``, and the host clock's
for work on the CPU."""

from __future__ import annotations

import subprocess
import time

import torch


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean ms per call of fn() over `reps` calls after one warm-up call,
    timed with CUDA events on the current stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times work on a CUDA device; none is available")
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() on the CPU after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_info(device) -> dict:
    """The device a timing ran on: {"device": "cpu"}, or the card's name
    and nvidia-smi's name and power limit for it (a card set below its
    maximum power runs slower under load)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": device.type}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        smi = f"not read ({e})"
    return {"device": torch.cuda.get_device_name(index), "nvidia_smi": smi}


def timed(fn, device: torch.device):
    """(fn(), seconds) of one call: CUDA events on a CUDA device, else the
    host clock."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0
