"""Kernel and stage timing on the card, the port's counterpart of
``videoseal_tpu/evals/stage_bench.py::time_stage``."""

from __future__ import annotations

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
