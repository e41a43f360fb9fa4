"""Layer: the pipelines. CUDA runtime calls that make the host wait, per
traced request, less the one the harness makes to end a request."""

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    if run.trace is None or not run.traced_requests or not run.trace.kernels:
        return None
    n = sum(1 for e in run.trace.runtime if e.name in WAITS)
    return n / run.traced_requests - run.traffic.HARNESS_SYNCS
