"""Layer: the device. The caching allocator's peak over the measured window
(reset after set-up), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
