"""K2: one fused ConvNeXtV2 block, NHWC.

Replaces ``videoseal_tpu/kernels/convnext_block.py::convnext_block_fused``.
The CUDA kernel (``csrc/convnext_block.cu``) says what bounds it on the H100
and how it splits the block around GRN's per-frame reduction. This module
holds its plain PyTorch version (the same math, rounding at the same places)
and the wrapper that picks between them by the tensor's device: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel or raises.

GELU is the erf form (the model's definition). The TPU kernel used the tanh
form, which differs by up to ~3e-4 per activation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib


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


def convnext_block_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain PyTorch version of K2. x (B, H, W, C) f32 or bf16."""
    b, h, w, c = x.shape
    xf = x.float()
    xpad = F.pad(xf, (0, 0, 3, 3, 3, 3))
    acc = None
    for dy in range(7):
        part = None
        for dx in range(7):
            t = xpad[:, dy:dy + h, dx:dx + w] * p["dw"][dy * 7 + dx]
            part = t if part is None else part + t
        acc = part if acc is None else acc + part
    acc = acc + p["dwb"]
    mu = acc.mean(dim=-1, keepdim=True)
    var = (acc - mu).square().mean(dim=-1, keepdim=True)
    xn = (acc - mu) * torch.rsqrt(var + 1e-6) * p["lnw"] + p["lnb"]
    # bf16 operands are exact in f32, so f32 products give the bf16 product
    # with f32 accumulation
    hmid = xn.to(torch.bfloat16).float() @ p["w1"].float().t() + p["b1"]
    hf = F.gelu(hmid).to(torch.bfloat16).float()
    gx = torch.sqrt(torch.clamp(hf.square().sum(dim=(1, 2), keepdim=True), min=1e-12))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    y = ((p["gamma"] * nx) * hf + p["beta"] + hf).to(torch.bfloat16).float()
    out = (y @ p["w2"].float().t() + p["b2"]) + xf
    return out.to(x.dtype)


def _kernel_tile(h: int, w: int, c: int) -> int:
    """Pixels per block: 32 where the frame allows, else 16."""
    hw = h * w
    p = 32 if hw % 32 == 0 else 16
    if c % 16 or hw % 16 or (p // 16) * (c // 16) > 96:
        raise ValueError(f"convnext_block_fused kernel takes C % 16 == 0, "
                         f"H*W % 16 == 0 and C <= 768, got H={h} W={w} C={c}")
    return p


def _launch(x: torch.Tensor, p: dict) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"convnext_block_fused kernel takes f32 or bf16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("convnext_block_fused kernel takes a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    for k, v in p.items():
        if v.device != x.device or not v.is_contiguous():
            raise ValueError(f"parameter {k} must be contiguous on {x.device}")
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


convnext_block_fused.launches = 0
