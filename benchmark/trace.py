"""What a traced window holds, read from torch.profiler's Chrome trace: the
device's kernels, copies and fills, the CUDA runtime calls and the host's
operators, and the requests the harness marked with `REQUEST`."""

from __future__ import annotations

import dataclasses
import json

REQUEST = "bench.request"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Event:
    name: str
    ts: float    # microseconds
    dur: float
    cat: str
    tid: object = None


@dataclasses.dataclass
class Trace:
    device: list      # kernels, copies and fills
    runtime: list     # CUDA runtime and driver calls on the host
    host: list        # operators and the harness's marks on the host
    requests: list    # the harness's request marks

    @property
    def kernels(self) -> list:
        return [e for e in self.device if e.cat == "kernel"]

    def window_us(self) -> tuple[float, float]:
        """From the first traced request's submit to the last one's end."""
        return (min(e.ts for e in self.requests),
                max(e.ts + e.dur for e in self.requests))

    def busy_intervals(self) -> list:
        """The merged intervals in which something ran on the device, inside
        the window."""
        lo, hi = self.window_us()
        spans = sorted((max(e.ts, lo), min(e.ts + e.dur, hi)) for e in self.device
                       if e.ts < hi and e.ts + e.dur > lo)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the window with nothing on the device."""
        lo, hi = self.window_us()
        gaps, at = [], lo
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def host_doing(self, times: list) -> list:
        """For each time, the innermost host operator or runtime call of the
        harness's thread running then (they nest on one thread)."""
        tid = self.requests[0].tid if self.requests else None
        evs = sorted((e for e in self.host + self.runtime if e.tid == tid),
                     key=lambda e: (e.ts, -e.dur))
        out, stack, i = [None] * len(times), [], 0
        for t, k in sorted((t, k) for k, t in enumerate(times)):
            while i < len(evs) and evs[i].ts <= t:
                while stack and stack[-1].ts + stack[-1].dur < evs[i].ts:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1].ts + stack[-1].dur < t:
                stack.pop()
            out[k] = stack[-1].name if stack else "host outside any operator"
        return out


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = Trace([], [], [], [])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        ev = Event(e.get("name", ""), float(e["ts"]), float(e["dur"]), cat, e.get("tid"))
        if cat in _DEVICE:
            out.device.append(ev)
        elif cat in _RUNTIME:
            out.runtime.append(ev)
        elif ev.name == REQUEST and cat == "user_annotation":
            out.requests.append(ev)   # the host's mark (the device's copy has its own cat)
        elif cat in ("cpu_op", "user_annotation"):
            out.host.append(ev)
    return out


def top(pairs: dict, n: int = 10) -> list:
    """The n largest of {name: seconds}, as [name, seconds] lists."""
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time and the longest idle time,
    summed by what the host was doing, both in seconds."""
    ops: dict = {}
    for e in tr.device:
        ops[e.name[:160]] = ops.get(e.name[:160], 0.0) + e.dur * 1e-6
    idle: dict = {}
    gaps = tr.idle_gaps()
    for (a, b), name in zip(gaps, tr.host_doing([(a + b) / 2 for a, b in gaps])):
        idle[name[:160]] = idle.get(name[:160], 0.0) + (b - a) * 1e-6
    return {"device_ops": top(ops, n), "idle_gaps": top(idle, n)}
