"""Process start to the first timed request: imports, the CUDA context, the
kernel library (built on a checkout's first run), the weights, the pool and
the warm-up requests of the cell's own shapes."""


def read(run):
    return run.setup_s
