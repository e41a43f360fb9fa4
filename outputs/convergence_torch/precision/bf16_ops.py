"""The JAX package's accelerator precision on the port, as an experiment's
wrapper (ROADMAP §3.45): every float32 convolution and dense product takes
bfloat16 operands, accumulates in float32 and gives a float32 output, as a
float32 ``lax.conv_general_dilated`` or ``jnp.dot`` at the default precision
does on a TPU. Parameters, optimizer state, norms, softmaxes, losses and the
ops the JAX package runs at ``precision="highest"`` stay float32: their
counterparts in the port are ``@`` and ``torch.einsum`` (the message
table's product, ``ops/resize.py``'s matmuls, the ViT's and the VAE's
attention), which this wrapper leaves alone; it takes ``F.conv2d``,
``F.conv3d``, ``F.conv_transpose2d`` and ``F.linear``, the functions every
``nn.Conv*``, ``nn.Linear`` and the JND's stencils call.

Each operand is rounded to bfloat16 (round to nearest even) and handed to
the float32 op as float32: a product of two bfloat16 values is exact in
float32 and in TF32, so cuDNN and cuBLAS add exact products in float32, and
the output keeps float32's precision (a bfloat16 cuDNN convolution would
round it to bfloat16). The backward rounds the incoming gradient to
bfloat16 before the transposed products, as JAX's transpose of a
default-precision op does; the rounding of an operand passes the gradient
through unchanged. The bias is added after the product, in float32, as
flax adds it. ``install()`` applies the wrapper in the calling process
(run.sh's bf16 arm calls it before ``videoseal_tpu_torch.train.main``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

OPS = ("conv2d", "conv3d", "conv_transpose2d", "linear")
BIAS_AT = 2     # the bias's place among each of OPS' positional arguments


class _Operand(torch.autograd.Function):
    """x rounded to bfloat16 and back; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _Cotangent(torch.autograd.Function):
    """The identity; its gradient rounded to bfloat16 and back."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _wrap(name: str, fn):
    def op(*args, **kwargs):
        x, w = args[0], args[1]
        if x.dtype != torch.float32 or w.dtype != torch.float32:
            return fn(*args, **kwargs)
        args = list(args)
        if len(args) > BIAS_AT:
            bias, args[BIAS_AT] = args[BIAS_AT], None
        else:
            bias = kwargs.pop("bias", None)
        args[0], args[1] = _Operand.apply(x), _Operand.apply(w)
        y = _Cotangent.apply(fn(*args, **kwargs))
        if bias is None:
            return y
        return y + (bias if name == "linear" else bias.reshape((1, -1) + (1,) * (y.dim() - 2)))

    return op


def install() -> None:
    """Replace OPS in ``torch.nn.functional`` by their bfloat16-operand
    forms."""
    for n in OPS:
        setattr(F, n, _wrap(n, getattr(F, n)))
