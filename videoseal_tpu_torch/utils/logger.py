"""Metric logging, counterpart of ``videoseal_tpu/utils/logger.py``
(the reference's MetricLogger and SmoothedValue): windowed medians and
global averages per metric; `sync` sums the global averages' totals and
counts over the process group."""

from __future__ import annotations

import collections
import statistics


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.window = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float, n: int = 1):
        self.window.append(v)
        self.total += v * n
        self.count += n

    @property
    def median(self):
        return statistics.median(self.window) if self.window else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def recent(self) -> dict:
        """Windowed medians: the trajectory (global_avg flattens a trend
        into the lifetime mean)."""
        return {k: m.median for k, m in self.meters.items()}

    def line(self, prefix: str = "", keys=None) -> str:
        keys = keys or list(self.meters)
        parts = [prefix] if prefix else []
        for k in keys:
            m = self.meters[k]
            parts.append(f"{k}: {m.median:.4f} ({m.global_avg:.4f})")
        return self.delimiter.join(parts)

    def sync(self, group=None):
        """Sum every meter's total and count over the process group (every
        rank calls it at the same point, with the same meters); a single
        process is left as it is."""
        import torch
        import torch.distributed as dist

        from .dist import comm_device, is_dist_avail_and_initialized
        if not is_dist_avail_and_initialized():
            return
        keys = sorted(self.meters)
        vals = torch.tensor([[self.meters[k].total, self.meters[k].count] for k in keys],
                            dtype=torch.float64, device=comm_device(group))
        dist.all_reduce(vals, group=group)
        for k, (total, count) in zip(keys, vals.tolist()):
            self.meters[k].total, self.meters[k].count = total, int(count)
