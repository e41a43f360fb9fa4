"""Layer: the blend kernels. K1 (`blend_planar_kernel` and its detect
height pass) per request against its least time at the request's shapes:
bytes and operations of benchmark/costs.k1_cost, H100 SXM peaks."""

from .. import costs
from ._kernels import per_request_ms


def read(run):
    ms = per_request_ms(run, r"blend_planar_kernel|detect_height_kernel")
    if ms is None:
        return None
    w, s = run.workload, run.card["args"]["img_size_proc"]
    least, _ = costs.bound(*costs.k1_cost(w["frames"], w["height"], w["width"], s,
                                          w["lowres"], s))
    return 100.0 * least / ms
