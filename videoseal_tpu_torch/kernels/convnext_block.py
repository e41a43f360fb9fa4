"""K2: one ConvNeXtV2 block, NHWC; K3: k consecutive blocks in one launch.

K2 replaces ``videoseal_tpu/kernels/convnext_block.py::convnext_block_fused``,
K3 ``convnext_blocks_fused``. K2 is four launches: ``dwln`` (depthwise 7x7 +
LN, ``csrc/convnext_dwln.cu``), then ``pw1``, ``grn_stats`` and ``pw2``
(``csrc/convnext_pw.cu`` on the tiled tensor-core GEMM of
``csrc/gemm_tn.cuh``); the sources say what bounds each on the H100. K3 and
the K8 probe run the earlier two-part design (``csrc/convnext_block.cuh``),
kept here as ``_launch_split``.
This module holds the plain PyTorch versions (the same math, rounding at
the same places; K2's plain version is its four parts' plain versions in
turn) and the wrappers that pick between them by the tensor's device: a CPU
tensor runs the plain version, a CUDA tensor launches the kernels or
raises.

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


def kernel_params(blk) -> dict:
    """`block_params(blk)`, built once and cached on the block. A hit is
    checked against every parameter's storage, dtype, device and `_version`
    counter, so `.to`, `with_dtype` (a copy, then a cast) and an in-place
    update build anew; a chunk's forward then launches no cast or
    transpose kernels."""
    key = tuple((t.data_ptr(), t.dtype, t.device, t._version) for t in blk.parameters())
    hit = blk.__dict__.get("_kernel_params")
    if hit is None or hit[0] != key:
        hit = (key, block_params(blk))
        blk.__dict__["_kernel_params"] = hit
    return hit[1]


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


def _dwln_padded(xpad: torch.Tensor, p: dict, dw_form: str = "perdy") -> torch.Tensor:
    """dwln on a padded input xpad (B, H+6, W+6, C) whose halo is read as
    it is: depthwise 7x7 + dwb, channel LN (eps 1e-6), rounded to bf16 ->
    A (B*H*W, C) bf16, row-major."""
    acc = dw_plain(xpad, p["dw"], dw_form) + p["dwb"]
    mu = acc.mean(dim=-1, keepdim=True)
    var = (acc - mu).square().mean(dim=-1, keepdim=True)
    xn = (acc - mu) * torch.rsqrt(var + 1e-6) * p["lnw"] + p["lnb"]
    return xn.to(torch.bfloat16).reshape(-1, xn.shape[-1])


def dwln_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain version of K2's first part, dwln: x (B, H, W, C) f32 or bf16
    with a zero 3-pixel halo -> A (B*H*W, C) bf16."""
    return _dwln_padded(F.pad(x, (0, 0, 3, 3, 3, 3)), p)


def pw1_plain(a: torch.Tensor, p: dict, frames: int, act: str = "erf") -> tuple:
    """Plain version of K2's pw1: A (M, C) bf16 times w1^T (bf16 operands,
    f32 sums) + b1, the activation, rounded to bf16 -> (hidden (M, 4C)
    bf16, per-frame sums of the bf16 hidden's squares (frames, 4C) f32).
    The kernel writes those sums as per-(frame, M tile) partials."""
    # bf16 operands are exact in f32, so f32 products give the bf16 product
    # with f32 accumulation
    h = ACTIVATIONS[act](a.float() @ p["w1"].float().t() + p["b1"]).to(torch.bfloat16)
    hf = h.float()
    return h, hf.square().view(frames, -1, hf.shape[-1]).sum(dim=1)


def grn_stats_plain(sums: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Plain version of K2's grn_stats: the per-frame sums of squares
    (B, 4C), or the kernel's partials (B, tiles, 4C) reduced in tile order,
    -> gn = gamma * nx (B, 4C) f32 with gx = sqrt(max(s, 1e-12)) and
    nx = gx / (mean_c gx + 1e-6)."""
    if sums.dim() == 3:
        s = sums[:, 0]
        for t in range(1, sums.shape[1]):
            s = s + sums[:, t]
        sums = s
    gx = torch.sqrt(torch.clamp(sums, min=1e-12))
    return gamma * (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6))


def pw2_plain(h: torch.Tensor, gn: torch.Tensor, p: dict, res: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K2's pw2: the GRN output bf16(gn * h + beta + h) of
    the hidden h (M, 4C) bf16 with its frame's gn (B, 4C), times w2^T (f32
    sums) + b2 + the residual res (B, H, W, C) -> (B, H, W, C) in out_dtype."""
    hf = h.float().view(gn.shape[0], -1, h.shape[-1])
    y = (gn[:, None] * hf + p["beta"] + hf).to(torch.bfloat16).float()
    out = (y.view(h.shape) @ p["w2"].float().t() + p["b2"]).view(res.shape) + res.float()
    return out.to(out_dtype)


def block_plain_padded(xpad: torch.Tensor, p: dict, out_dtype: torch.dtype,
                       dw_form: str = "perdy", act: str = "erf") -> torch.Tensor:
    """One block on a padded input xpad (B, H+6, W+6, C), f32 or bf16, whose
    halo is read as it is; the residual is xpad's interior. K2 is
    dw_form="perdy", act="erf" on a zero halo: the four parts in turn."""
    b, h, w = xpad.shape[0], xpad.shape[1] - 6, xpad.shape[2] - 6
    hid, sums = pw1_plain(_dwln_padded(xpad, p, dw_form), p, b, act)
    return pw2_plain(hid, grn_stats_plain(sums, p["gamma"]), p, xpad[:, 3:3 + h, 3:3 + w],
                     out_dtype)


def convnext_block_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain PyTorch version of K2. x (B, H, W, C) f32 or bf16: dwln, pw1,
    grn_stats and pw2 in turn."""
    hid, sums = pw1_plain(dwln_plain(x, p), p, x.shape[0])
    return pw2_plain(hid, grn_stats_plain(sums, p["gamma"]), p, x, x.dtype)


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


# the new K2's limit (csrc/convnext_dwln.cu): the shared memory of a block
SMEM_MAX = 232448


def _check_shape(b: int, h: int, w: int, c: int) -> int:
    """The new K2's shape check: C % 16 == 0 (16-byte rows for cp.async and
    the vector loads), H*W % 16 == 0, and one image row of dwln's f32 output,
    all channels, within shared memory. Returns the GEMMs' frame-local M
    tile: 128 rows where a frame has that many, else 64."""
    hw = h * w
    if c % 16 or hw % 16 or 4 * w * c > SMEM_MAX:
        raise ValueError(f"convnext_block_fused kernel takes C % 16 == 0, H*W % 16 == 0 and "
                         f"4*W*C <= {SMEM_MAX} bytes of shared memory, got H={h} W={w} C={c}")
    bm = 128 if hw >= 128 else 64
    if b * -(-hw // bm) > 65535:
        raise ValueError(f"convnext_block_fused kernel takes at most 65535 (frame, M tile) "
                         f"pairs, got {b} frames of {hw} pixels")
    return bm


def k2_parts(x: torch.Tensor, p: dict) -> tuple[list, dict]:
    """The new K2's four launches on x, in order, as (name, call) pairs over
    buffers allocated here, and the buffers: "a" (dwln's output), "hid" and
    "part" (pw1's), "gn" (grn_stats'), "out" (pw2's). Each call launches its
    kernel and raises if the launch fails."""
    _check("convnext_block_fused", x, [p])
    b, h, w, c = x.shape
    bm = _check_shape(b, h, w, c)
    if x.data_ptr() % 16:
        raise ValueError("convnext_block_fused kernel takes x at a 16-byte aligned address")
    hw, n4 = h * w, 4 * c
    tiles = -(-hw // bm)
    dev = x.device
    buf = {"a": torch.empty((b * hw, c), dtype=torch.bfloat16, device=dev),
           "hid": torch.empty((b * hw, n4), dtype=torch.bfloat16, device=dev),
           "part": torch.empty((b, tiles, n4), dtype=torch.float32, device=dev),
           "gn": torch.empty((b, n4), dtype=torch.float32, device=dev),
           "out": torch.empty_like(x)}
    lib, stream = _lib.library(), _lib.stream_ptr(x)
    sfx = "f32" if x.dtype == torch.float32 else "bf16"
    ptr = {k: v.data_ptr() for k, v in buf.items()}
    pp = {k: v.data_ptr() for k, v in p.items()}

    def dwln():
        _lib.check(getattr(lib, f"vs_cnx_dwln_{sfx}")(
            x.data_ptr(), pp["dw"], pp["dwb"], pp["lnw"], pp["lnb"], ptr["a"], b, h, w, c, stream),
            "vs_cnx_dwln")

    def pw1():
        _lib.check(lib.vs_cnx_pw1(ptr["a"], pp["w1"], pp["b1"], ptr["hid"], ptr["part"], b, hw,
                                  c, bm, stream), "vs_cnx_pw1")

    def grn_stats():
        _lib.check(lib.vs_cnx_grn(ptr["part"], pp["gamma"], ptr["gn"], b, tiles, n4, stream),
                   "vs_cnx_grn")

    def pw2():
        _lib.check(getattr(lib, f"vs_cnx_pw2_{sfx}")(
            ptr["hid"], ptr["gn"], pp["beta"], pp["w2"], pp["b2"], x.data_ptr(), ptr["out"], b,
            hw, c, bm, stream), "vs_cnx_pw2")

    return [("dwln", dwln), ("pw1", pw1), ("grn_stats", grn_stats), ("pw2", pw2)], buf


def _launch(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The new K2: dwln, pw1, grn_stats and pw2, four launches."""
    calls, buf = k2_parts(x, p)
    for _, call in calls:
        call()
    return buf["out"]


def _launch_split(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The earlier K2 design, parts (a) and (b) of csrc/convnext_block.cuh
    (K3 and the K8 probe run the same device functions): the yardstick K3 is
    held against bit for bit, and the new design's before. Not on a path."""
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
    Hopper kernels for a CUDA tensor (which raise on what they do not take).
    One count per call, whatever the launches inside."""
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
