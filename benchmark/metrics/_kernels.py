"""Device time of the traced window's kernels, by name pattern, per request."""

from __future__ import annotations

import re


def per_request_ms(run, pattern: str, exclude: str | None = None) -> float | None:
    """ms a traced request in kernels whose name matches `pattern` (and not
    `exclude`); None where the trace holds no such kernel."""
    if run.trace is None or not run.traced_requests:
        return None
    inc, exc = re.compile(pattern), re.compile(exclude) if exclude else None
    durs = [e.dur for e in run.trace.kernels
            if inc.search(e.name) and not (exc and exc.search(e.name))]
    if not durs:
        return None
    return sum(durs) * 1e-3 / run.traced_requests
