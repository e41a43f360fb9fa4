"""The whole request: the model FLOPs of the window's requests (counted on
the reference at the cell's shapes, benchmark/costs.model_flops) over the
window's seconds and the H100's bf16 peak."""

from .. import costs


def read(run):
    if not run.spans:
        return None
    flops = run.traffic.flops(run.card, run.workload) * len(run.spans)
    return 100.0 * flops / run.window_s / costs.BF16_FLOPS
