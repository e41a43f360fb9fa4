"""Layer: the API. Median host ms from a request's submit to the entry's
return (what the host spends enqueueing), over the measured window."""

import statistics


def read(run):
    if not run.spans:
        return None
    return statistics.median((ret - sub) * 1e3 for sub, ret, _ in run.spans)
