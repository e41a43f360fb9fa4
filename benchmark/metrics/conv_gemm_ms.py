"""Layer: the embedder's convolutions and the resizes' products on cuDNN,
cuBLAS and CUTLASS. Device ms per traced request in their kernels."""

from ._kernels import per_request_ms

# the libraries' kernel names; the port's own kernels are left out by name
LIBRARY = (r"gemm|gemv|cudnn|cublas|cutlass|xmma|nvjet|implicit_convolve|conv2d|convolve|"
           r"fprop|dgrad|wgrad|sm90_|sm80_|ampere_|hopper_")
PORT = r"cnx_|blend_planar|detect_height|jnd_|at::native"


def read(run):
    return per_request_ms(run, LIBRARY, PORT)
