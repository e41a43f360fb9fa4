"""Layer: the pipelines. Device kernels per traced request (copies and
fills not counted)."""


def read(run):
    if run.trace is None or not run.traced_requests or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.traced_requests
