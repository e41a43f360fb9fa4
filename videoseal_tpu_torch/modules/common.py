"""Shared neural blocks, counterpart of ``videoseal_tpu/modules/common.py``.

Convolutional blocks run NCHW (PyTorch's convolution layout); the ConvNeXt
path runs NHWC. Parameter names and shapes follow the reference PyTorch
modules, so a reference state_dict loads directly:

* ``ChannelLayerNorm``: LayerNorm over the channel axis (eps 1e-6),
  ``weight``/``bias`` of shape (C,);
* ``GRN``: ``gamma``/``beta`` of shape (1, 1, 1, C), 1e-12 floor under the
  square root;
* ``make_norm``: "batch" is ``BatchNorm2d`` (eps 1e-5): in eval mode
  ``nn.BatchNorm2d``'s, in train mode flax's (the batch's statistics, and
  running statistics updated at momentum 0.9 with the biased variance);
  "group" ``nn.GroupNorm`` (8 groups, eps 1e-5); "layer" a
  ``ChannelLayerNorm``; "rms" ``ChanRMSNorm``, ``gamma`` of shape (C, 1, 1);
* GELU is the exact erf form (``nn.GELU()``); SiLU and LeakyReLU (slope 0.2)
  complete the activation registry;
* ``Upsample`` (nearest, bilinear, transposed conv, pixelshuffle) and
  ``Downsample`` (pixel unshuffle, 1x1 conv);
* ``Conv2dOp``, ``Conv3dOp``, ``Conv2p1dOp`` (``get_conv_op``) and
  ``TemporalConv``: the batch axis of a video chunk is time, so a 3D or
  temporal convolution mixes the frames of the batch it is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear


def get_activation(name: str) -> nn.Module:
    if name == "relu":
        return nn.ReLU()
    if name == "leakyrelu":
        return nn.LeakyReLU(0.2)
    if name == "gelu":
        return nn.GELU()
    if name == "silu":
        return nn.SiLU()
    raise NotImplementedError(f"activation {name!r}")


def channel_ln(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dim: int, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over axis `dim` (eps 1e-6, as every ConvNeXt/UNet LN of the
    model), computed in float32 (float64 stays), returned in x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=dim, keepdim=True)
    var = (xf - mu).square().mean(dim=dim, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[dim] = -1
    y = y * weight.to(xf.dtype).reshape(shape) + bias.to(xf.dtype).reshape(shape)
    return y.to(x.dtype)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis only. `channels_last` selects NHWC
    (axis -1) or NCHW (axis 1)."""

    def __init__(self, dim: int, channels_last: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.channels_last = channels_last

    def forward(self, x):
        return channel_ln(x, self.weight, self.bias, -1 if self.channels_last else 1)


class GRN(nn.Module):
    """Global Response Normalization over (H, W) of NHWC input."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))   # float64 stays
        gx = torch.sqrt(torch.clamp(xf.square().sum(dim=(-3, -2), keepdim=True),
                                    min=1e-12))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma.to(xf.dtype) * (xf * nx) + self.beta.to(xf.dtype) + xf).to(x.dtype)


class ChanRMSNorm(nn.Module):
    """RMS norm over the channel axis of NCHW input: F.normalize over C
    times sqrt(C) times gamma, with the JAX package's floors (1e-24 under the
    square root, 1e-12 on the norm), in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim, 1, 1))

    def forward(self, x):
        norm = torch.sqrt(torch.clamp(x.square().sum(dim=1, keepdim=True), min=1e-24))
        return x / torch.clamp(norm, min=1e-12) * self.scale * self.gamma


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalisation over the batch of every rank of `group`
    (NCHW). Forward: each rank's count, mean and centred sum of squares in
    one all-reduce (a row per rank, combined in rank order). Backward: the
    sums of dy and dy * xhat over every rank in one all-reduce, then
    BatchNorm's usual input gradient; the affine parameters' gradients are
    the rank's own (the step averages them over the group)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        import torch.distributed as dist
        c, rank, world = x.shape[1], dist.get_rank(group), dist.get_world_size(group)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))   # float64 stays
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        n = float(x.numel() // c)
        rows = x.new_zeros((world, 2 * c + 1), dtype=xf.dtype)
        rows[rank] = torch.cat([mean, var * n, mean.new_full((1,), n)])
        dist.all_reduce(rows, group=group)
        counts = rows[:, -1:]
        total = counts.sum()
        g_mean = (rows[:, :c] * counts).sum(0) / total
        g_var = (rows[:, c:2 * c].sum(0) + ((rows[:, :c] - g_mean) ** 2 * counts).sum(0)) / total
        invstd = torch.rsqrt(g_var + eps)
        xhat = (xf - g_mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(xhat, weight, invstd, total)
        ctx.group = group
        ctx.mark_non_differentiable(g_mean, g_var)
        y = xhat * weight.to(xf.dtype)[:, None, None] + bias.to(xf.dtype)[:, None, None]
        return y.to(x.dtype), g_mean, g_var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        import torch.distributed as dist
        xhat, weight, invstd, total = ctx.saved_tensors
        dyf = dy.to(xhat.dtype)
        local = torch.stack([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        scale = (weight.to(xhat.dtype) * invstd)[:, None, None]
        dx = (dyf - sums[0][:, None, None] / total
              - xhat * (sums[1] / total)[:, None, None]) * scale
        return (dx.to(dy.dtype), local[1].to(weight.dtype), local[0].to(weight.dtype),
                None, None)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running variance with
    the batch's biased variance, as flax's ``nn.BatchNorm`` (momentum 0.9)
    does; torch's own uses the unbiased one, n/(n-1) times larger. The
    state dict is ``nn.BatchNorm2d``'s.

    With `group` set (``parallel.mesh.use_global_batchnorm``: every rank of
    the mesh), train mode normalises with the statistics of the global
    batch, as the JAX step over a sharded batch does, and its backward
    carries both cross-rank terms (`_GlobalBatchNorm`). A rank may hold a
    copy of the whole batch (``apply_whole_batch``): every rank holding the
    same copy leaves the mean, the biased variance and, once the copies'
    input gradients are summed, the backward as they are."""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                  self.group)
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
                self.num_batches_tracked += 1
            return y
        with torch.no_grad():
            xs = x.to(self.running_mean.dtype)
            self.running_mean.lerp_(xs.mean(dim=(0, 2, 3)), self.momentum)
            self.running_var.lerp_(xs.var(dim=(0, 2, 3), correction=0), self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def make_norm(kind: str, dim: int) -> nn.Module:
    """The reference's norm registry, on NCHW input."""
    if kind.startswith("batch"):
        return BatchNorm2d(dim, eps=1e-5)
    if kind.startswith("group"):
        return nn.GroupNorm(8, dim, eps=1e-5)
    if kind.startswith("layer"):
        return ChannelLayerNorm(dim)
    if kind.startswith("rms"):
        return ChanRMSNorm(dim)
    raise NotImplementedError(f"normalization {kind!r}")


class Interpolate(nn.Module):
    """Bilinear x`factor` resample of NCHW input with the JAX package's
    matrices (no antialias). f32 input resamples in f32, bf16 and f16 input
    in bf16, as ``videoseal_tpu.modules.common.Upsample`` does; f64 in f64."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        if self.factor == 1:
            return x
        h, w = x.shape[-2] * self.factor, x.shape[-1] * self.factor
        prec = "default" if x.dtype in (torch.bfloat16, torch.float16) else "highest"
        y = resize_bilinear(x.permute(0, 2, 3, 1), h, w, antialias=False,
                            precision=prec, out_dtype=x.dtype)
        return y.permute(0, 3, 1, 2)


class ReflectPad1(nn.Module):
    """Pad H and W of NCHW input by 1 in ``jnp.pad``'s "reflect" mode: a
    size-1 axis repeats its value, where ``nn.ReflectionPad2d`` raises."""

    def forward(self, x):
        for pad, n in (((1, 1, 0, 0), x.shape[-1]), ((0, 0, 1, 1), x.shape[-2])):
            x = F.pad(x, pad, mode="reflect" if n > 1 else "replicate")
        return x


class Nearest(nn.Module):
    """Nearest x`factor` resample of NCHW input (each pixel repeated)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        f = self.factor
        return x if f == 1 else x.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax's ``nn.ConvTranspose`` (stride = kernel, VALID) on NCHW input. The
    weight (I, O, kh, kw) is the JAX kernel (kh, kw, I, O) transposed, as the
    reference's converter reads it; flax applies that kernel spatially
    flipped against ``nn.ConvTranspose2d``, so the forward flips it."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.flip(-2, -1), self.bias, self.stride)


class Upsample(nn.Module):
    """Upscale block on NCHW; `upsample_block` indices follow the reference:

    * nearest | bilinear: resample -> reflect pad -> 3x3 conv -> channel LN
      -> act (conv at index 2, LN at 3);
    * conv: transposed conv (kernel = stride = factor, with bias) -> LN -> act;
    * pixelshuffle: 1x1 conv to out * f * f -> LN -> act -> PixelShuffle(f),
      whose (c, f, f) channel order is JAX's NHWC depth-to-space."""

    def __init__(self, upscale_type: str, in_channels: int, out_channels: int,
                 up_factor: int, activation: str):
        super().__init__()
        f = up_factor
        if upscale_type in ("nearest", "bilinear"):
            layers = [Nearest(f) if upscale_type == "nearest" else Interpolate(f), ReflectPad1(),
                      nn.Conv2d(in_channels, out_channels, 3, bias=False),
                      ChannelLayerNorm(out_channels)]
        elif upscale_type == "conv":
            layers = [ConvTranspose(in_channels, out_channels, f, stride=f),
                      ChannelLayerNorm(out_channels)]
        elif upscale_type == "pixelshuffle":
            layers = [nn.Conv2d(in_channels, out_channels * f * f, 1, bias=False),
                      ChannelLayerNorm(out_channels * f * f)]
        else:
            raise ValueError(f"Invalid upscaling type: {upscale_type}")
        layers.append(get_activation(activation))
        if upscale_type == "pixelshuffle":
            layers.append(nn.PixelShuffle(f))
        self.upsample_block = nn.Sequential(*layers)

    def forward(self, x):
        return self.upsample_block(x)


class Downsample(nn.Module):
    """PixelUnshuffle(2) -> 1x1 conv (with bias) -> act on NCHW; torch's
    (c, 2, 2) channel order is JAX's. The conv is ``downsample_block.1``."""

    def __init__(self, in_channels: int, out_channels: int, activation: str):
        super().__init__()
        self.downsample_block = nn.Sequential(
            nn.PixelUnshuffle(2), nn.Conv2d(4 * in_channels, out_channels, 1),
            get_activation(activation))

    def forward(self, x):
        return self.downsample_block(x)


# -- convolutions over frames: the batch axis of NCHW input is time ----------

class TemporalConv(nn.Conv3d):
    """A k x 1 x 1 convolution over the frame axis, zero-padded by k // 2 at
    both ends, without bias: (F, C, H, W) -> (F, C', H, W). Its weight is
    (C', C, k, 1, 1), the reference's ``temp_conv``."""

    mixes_frames = True

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__(in_channels, out_channels, (kernel_size, 1, 1),
                         padding=(kernel_size // 2, 0, 0), bias=False)

    def forward(self, x):
        return super().forward(x.transpose(0, 1)[None])[0].transpose(0, 1)


def _same_pad(kernel_size: int, padding) -> int:
    return kernel_size // 2 if padding is None else padding


class Conv2dOp(nn.Conv2d):
    """A 2D convolution, frames riding the batch axis; padding defaults to
    k // 2. The reference's plain ``nn.Conv2d`` (``<p>.weight``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int | None = None, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=_same_pad(kernel_size, padding), bias=bias)


class Conv3dOp(nn.Module):
    """A k x k x k convolution over (frames, H, W), the batch axis as time,
    stride (1, s, s): (F, C, H, W) -> (F, C', H', W'). ``<p>.conv.weight`` is
    (C', C, k, k, k)."""

    mixes_frames = True

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int | None = None, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride=(1, stride, stride),
                              padding=_same_pad(kernel_size, padding), bias=bias)

    def forward(self, x):
        return self.conv(x.transpose(0, 1)[None])[0].transpose(0, 1)


class Conv2p1dOp(nn.Module):
    """A 2D convolution (``<p>.conv``), then a `temporal_kernel_size` x 1 x 1
    convolution over frames (``<p>.temp_conv``, no bias). The temporal
    kernel defaults to the spatial one, and a 1x1 convolution has none, as
    in the JAX package."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int | None = None, bias: bool = True,
                 temporal_kernel_size: int | None = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=_same_pad(kernel_size, padding), bias=bias)
        kt = kernel_size if temporal_kernel_size is None else temporal_kernel_size
        self.temp_conv = (TemporalConv(out_channels, out_channels, kt)
                          if kernel_size != 1 else None)

    def forward(self, x):
        x = self.conv(x)
        return x if self.temp_conv is None else self.temp_conv(x)


def get_conv_op(name: str):
    if name == "conv2d":
        return Conv2dOp
    if name == "conv3d":
        return Conv3dOp
    if name == "conv2p1d":
        return Conv2p1dOp
    raise NotImplementedError(f"conv layer {name!r}")


def mixes_frames(module: nn.Module) -> bool:
    """Does `module` hold a layer whose output at a frame depends on other
    frames (a temporal or 3D convolution, temporal attention: each sets
    ``mixes_frames``)?"""
    return any(getattr(m, "mixes_frames", False) for m in module.modules())


def apply_whole_batch(module: nn.Module, mesh, rows: torch.Tensor, total: int, *inputs):
    """`module(*inputs)`, each input this rank's `rows` of a global batch of
    `total` rows (``parallel.mesh.Mesh.rows``). A module that mixes frames
    treats the batch axis as time, so on a mesh it runs on the whole batch
    in (data, frames) order, gathered differentiably over every rank, and
    this rank's rows of its output come back; any other module runs on the
    rank's rows."""
    if mesh is None or mesh.world == 1 or not mixes_frames(module):
        return module(*inputs)
    from ..utils.dist import gather_rows
    out = module(*(gather_rows(x, rows, total, mesh.all_group) for x in inputs))
    return out[rows.to(out.device)]
