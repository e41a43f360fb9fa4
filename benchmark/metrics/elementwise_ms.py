"""Layer: PyTorch's glue around the kernels (the JND's torch path, casts,
pads, copies, reductions). Device ms per traced request in PyTorch's own
kernels."""

from ._kernels import per_request_ms

TORCH = r"at::native|at_cuda_detail|CatArrayBatchedCopy|elementwise_kernel|reduce_kernel"


def read(run):
    return per_request_ms(run, TORCH)
