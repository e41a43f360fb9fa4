"""Layer: the extractor. K2's four parts (`cnx_*`) per request against the
least time of every ConvNeXt block of the request (benchmark/costs.block_cost
at the card's stage shapes and true widths), H100 SXM peaks."""

from .. import costs
from ._kernels import per_request_ms


def read(run):
    ms = per_request_ms(run, r"cnx_")
    if ms is None:
        return None
    return 100.0 * costs.k2_bound_ms(run.card, run.workload["frames"]) / ms
