"""Layer: the device. The share of the traced window in which nothing ran
on the device (torch.profiler's timeline)."""


def read(run):
    if run.trace is None or not run.trace.requests or not run.trace.device:
        return None
    lo, hi = run.trace.window_us()
    return 100.0 * (1.0 - run.trace.busy_us() / (hi - lo))
