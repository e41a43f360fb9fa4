"""K2: one fused ConvNeXtV2 block, NHWC; K3: k consecutive blocks in one
launch.

K2 replaces ``videoseal_tpu/kernels/convnext_block.py::convnext_block_fused``,
K3 ``convnext_blocks_fused``. The CUDA sources (``csrc/convnext_block.cuh``
and ``.cu``, K3 in ``csrc/convnext_group.cuh``) say what bounds the kernels
on the H100, how a block is split around GRN's per-frame reduction and how
K3 walks its phases in one cooperative launch.
This module holds their plain PyTorch versions (the same math, rounding at
the same places) and the wrappers that pick between them by the tensor's
device: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel or raises.

GELU is the erf form (the model's definition). The TPU kernel used the tanh
form, which differs by up to ~3e-4 per activation.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _lib

# one block's parameters in the order of csrc's BlockW
_PARAM_ORDER = ("dw", "dwb", "lnw", "lnb", "w1", "b1", "gamma", "beta", "w2", "b2")
MAX_GROUP = 4   # blocks per K3 launch (csrc MAXK)


def block_params(blk) -> dict:
    """A ConvNeXtBlock's parameters in the layout both versions read:
    dw (49, C) f32; the pointwise weights in torch Linear layout (out, in),
    bf16; every vector f32."""
    c = blk.dwconv.weight.shape[0]
    f32 = lambda t: t.detach().float().reshape(-1).contiguous()
    return {
        "dw": blk.dwconv.weight.detach().float().reshape(c, 49).t().contiguous(),
        "dwb": f32(blk.dwconv.bias), "lnw": f32(blk.norm.weight),
        "lnb": f32(blk.norm.bias),
        "w1": blk.pwconv1.weight.detach().to(torch.bfloat16).contiguous(),
        "b1": f32(blk.pwconv1.bias), "gamma": f32(blk.grn.gamma),
        "beta": f32(blk.grn.beta),
        "w2": blk.pwconv2.weight.detach().to(torch.bfloat16).contiguous(),
        "b2": f32(blk.pwconv2.bias),
    }


def dw_plain(xpad: torch.Tensor, dw: torch.Tensor, form: str = "perdy") -> torch.Tensor:
    """Depthwise 7x7 sum, without its bias, of part (a)'s ``dw_sum<DW>``:
    "perdy" per-row partials (K2), "taps" one chain with dy outer, "shift"
    one chain with dx outer, "bf16" bf16 products and sums. xpad (B, H+6,
    W+6, C) -> (B, H, W, C) f32."""
    h, w = xpad.shape[1] - 6, xpad.shape[2] - 6
    if form == "bf16":
        xb, wb = xpad.to(torch.bfloat16), dw.to(torch.bfloat16)
        acc = torch.zeros_like(xb[:, :h, :w])
        for dy in range(7):
            for dx in range(7):
                acc = acc + xb[:, dy:dy + h, dx:dx + w] * wb[dy * 7 + dx]
        return acc.float()
    xf = xpad.float()
    tap = lambda dy, dx: xf[:, dy:dy + h, dx:dx + w] * dw[dy * 7 + dx]
    if form == "perdy":
        acc = None
        for dy in range(7):
            part = None
            for dx in range(7):
                t = tap(dy, dx)
                part = t if part is None else part + t
            acc = part if acc is None else acc + part
        return acc
    if form == "taps":
        order = [(dy, dx) for dy in range(7) for dx in range(7)]
    elif form == "shift":
        order = [(dy, dx) for dx in range(7) for dy in range(7)]
    else:
        raise ValueError(f"unknown depthwise form {form!r}")
    acc = None
    for dy, dx in order:
        t = tap(dy, dx)
        acc = t if acc is None else acc + t
    return acc


# part (a)'s activation after pw1, act<ACT> in csrc: erf is the model's GELU
ACTIVATIONS = {
    "erf": F.gelu,
    "none": lambda v: v,
    "tanh": lambda v: 0.5 * v * (1.0 + torch.tanh(0.7978845608 * (v + 0.044715 * v * v * v))),
    "sigmoid": lambda v: v * torch.sigmoid(1.702 * v),
}


def block_plain_padded(xpad: torch.Tensor, p: dict, out_dtype: torch.dtype,
                       dw_form: str = "perdy", act: str = "erf") -> torch.Tensor:
    """One block on a padded input xpad (B, H+6, W+6, C), f32 or bf16, whose
    halo is read as it is; the residual is xpad's interior. K2 is
    dw_form="perdy", act="erf" on a zero halo."""
    h, w = xpad.shape[1] - 6, xpad.shape[2] - 6
    acc = dw_plain(xpad, p["dw"], dw_form) + p["dwb"]
    mu = acc.mean(dim=-1, keepdim=True)
    var = (acc - mu).square().mean(dim=-1, keepdim=True)
    xn = (acc - mu) * torch.rsqrt(var + 1e-6) * p["lnw"] + p["lnb"]
    # bf16 operands are exact in f32, so f32 products give the bf16 product
    # with f32 accumulation
    hmid = xn.to(torch.bfloat16).float() @ p["w1"].float().t() + p["b1"]
    hf = ACTIVATIONS[act](hmid).to(torch.bfloat16).float()
    gx = torch.sqrt(torch.clamp(hf.square().sum(dim=(1, 2), keepdim=True), min=1e-12))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    y = ((p["gamma"] * nx) * hf + p["beta"] + hf).to(torch.bfloat16).float()
    out = (y @ p["w2"].float().t() + p["b2"]) + xpad[:, 3:3 + h, 3:3 + w].float()
    return out.to(out_dtype)


def convnext_block_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain PyTorch version of K2. x (B, H, W, C) f32 or bf16."""
    return block_plain_padded(F.pad(x, (0, 0, 3, 3, 3, 3)), p, x.dtype)


def convnext_blocks_plain(x: torch.Tensor, params_list) -> torch.Tensor:
    """Plain PyTorch version of K3: the K2 block over each of params_list in
    turn, every intermediate rounded to bf16, the last block's output in x's
    dtype (as the TPU kernel's _kernel_multi). For bf16 x this is k
    sequential K2 plain calls."""
    if not params_list:
        raise ValueError("convnext_blocks: params_list is empty")
    y = x
    for p in params_list[:-1]:
        y = convnext_block_plain(y, p).to(torch.bfloat16)
    return convnext_block_plain(y.to(x.dtype), params_list[-1])


def _kernel_tile(h: int, w: int, c: int) -> int:
    """Pixels per block: 32 where the frame allows, else 16."""
    hw = h * w
    p = 32 if hw % 32 == 0 else 16
    if c % 16 or hw % 16 or (p // 16) * (c // 16) > 96:
        raise ValueError(f"convnext_block_fused kernel takes C % 16 == 0, "
                         f"H*W % 16 == 0 and C <= 768, got H={h} W={w} C={c}")
    return p


def _check(name: str, x: torch.Tensor, params_list, dtypes=(torch.float32, torch.bfloat16)):
    if x.dtype not in dtypes:
        raise TypeError(f"{name} kernel takes {dtypes}, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous 4-d NHWC tensor")
    for p in params_list:
        for k, v in p.items():
            if v.device != x.device or not v.is_contiguous():
                raise ValueError(f"parameter {k} must be contiguous on {x.device}")


def _launch(x: torch.Tensor, p: dict) -> torch.Tensor:
    _check("convnext_block_fused", x, [p])
    b, h, w, c = x.shape
    tile = _kernel_tile(h, w, c)
    lib = _lib.library()
    sfx = "f32" if x.dtype == torch.float32 else "bf16"
    xpad = F.pad(x, (0, 0, 3, 3, 3, 3)).contiguous()
    ntile = h * w // tile
    hmid = torch.empty((b, h * w, 4 * c), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((b, ntile, 4 * c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = _lib.stream_ptr(x)
    _lib.check(getattr(lib, f"vs_cnx_block_a_{sfx}")(
        xpad.data_ptr(), p["dw"].data_ptr(), p["dwb"].data_ptr(), p["lnw"].data_ptr(),
        p["lnb"].data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(), hmid.data_ptr(),
        part.data_ptr(), b, h, w, c, tile, stream), "vs_cnx_block_a")
    _lib.check(getattr(lib, f"vs_cnx_block_b_{sfx}")(
        hmid.data_ptr(), part.data_ptr(), p["gamma"].data_ptr(), p["beta"].data_ptr(),
        p["w2"].data_ptr(), p["b2"].data_ptr(), xpad.data_ptr(), out.data_ptr(),
        b, h, w, c, tile, stream), "vs_cnx_block_b")
    return out


def convnext_block_fused(x: torch.Tensor, p: dict) -> torch.Tensor:
    """K2 on `block_params` p: the plain version for a CPU tensor, the
    Hopper kernel for a CUDA tensor (which raises on what it does not take)."""
    if x.device.type == "cpu":
        return convnext_block_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_fused: unsupported device {x.device}")
    out = _launch(x, p)
    convnext_block_fused.launches += 1
    return out


def _launch_group(x: torch.Tensor, params_list) -> torch.Tensor:
    _check("convnext_blocks_fused", x, params_list)
    k = len(params_list)
    if not 1 <= k <= MAX_GROUP:
        raise ValueError(f"convnext_blocks_fused kernel takes 1 to {MAX_GROUP} blocks, got {k}")
    b, h, w, c = x.shape
    tile = _kernel_tile(h, w, c)
    xpad = F.pad(x, (0, 0, 3, 3, 3, 3)).contiguous()
    # the intermediates' ping-pong buffers; the kernel writes only inside
    # their 3-pixel zero halo
    pp = torch.zeros((min(k - 1, 2), b, h + 6, w + 6, c), dtype=torch.bfloat16,
                     device=x.device)
    hmid = torch.empty((b, h * w, 4 * c), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((b, h * w // tile, 4 * c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * (10 * k))(*[p[n].data_ptr() for p in params_list
                                          for n in _PARAM_ORDER])
    sfx = "f32" if x.dtype == torch.float32 else "bf16"
    _lib.check(getattr(_lib.library(), f"vs_cnx_group_{sfx}")(
        xpad.data_ptr(), pp[0].data_ptr() if k > 1 else None,
        pp[1].data_ptr() if k > 2 else None, out.data_ptr(), hmid.data_ptr(),
        part.data_ptr(), ctypes.addressof(ptrs), k, b, h, w, c, tile, _lib.stream_ptr(x)),
        "vs_cnx_group")
    return out


def convnext_blocks_fused(x: torch.Tensor, params_list) -> torch.Tensor:
    """K3: the blocks of params_list (each from `block_params`) in one
    launch: the plain version for a CPU tensor, the Hopper kernel for a CUDA
    tensor (which raises on what it does not take, such as more than
    MAX_GROUP blocks)."""
    if x.device.type == "cpu":
        return convnext_blocks_plain(x, params_list)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_blocks_fused: unsupported device {x.device}")
    out = _launch_group(x, params_list)
    convnext_blocks_fused.launches += 1
    return out


convnext_block_fused.launches = 0
convnext_blocks_fused.launches = 0
