"""95th percentile of every request's latency in the window, submit to
outputs ready, host clock (statistics.quantiles' exclusive method)."""

import statistics


def read(run):
    lat = [(done - sub) * 1e3 for sub, _, done in run.spans]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=100)[94]
