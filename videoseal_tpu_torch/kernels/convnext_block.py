"""K2: one ConvNeXtV2 block, NHWC; K3: k consecutive blocks in one launch.

K2 replaces ``videoseal_tpu/kernels/convnext_block.py::convnext_block_fused``,
K3 ``convnext_blocks_fused``. K2 is four launches: ``dwln`` (depthwise 7x7 +
LN, ``csrc/convnext_dwln.cu``), then ``pw1``, ``grn_stats`` and ``pw2``
(``csrc/convnext_pw.cu`` on the tiled tensor-core GEMM of
``csrc/gemm_tn.cuh``); the parts' bodies are device functions in
``csrc/convnext_dwln.cuh`` and ``csrc/convnext_pw.cuh``, which say what
bounds each on the H100. K3 (``csrc/convnext_group.cuh``) runs the same
parts as the 4k phases of one cooperative launch, bit for bit k K2 launches,
and the K8 probe (``kernels/convnext_probe.py``) runs them with its switches.
This module holds the plain PyTorch versions (the same math, rounding at
the same places; K2's plain version is its four parts' plain versions in
turn) and the wrappers that pick between them by the tensor's device: a CPU
tensor runs the plain version, a CUDA tensor launches the kernels or
raises.

Any width: a block whose width C is not a multiple of 16 (chunkyseal's
362, 724 and 1448) runs at the padded width Cp = ceil16(C), with 4 * Cp
hidden columns. `block_params` pads every parameter with zeros (taps, biases,
LN and GRN vectors, the rows and columns of both products) and records the
true width as p["c"]; the dwln kernel then takes the LN's statistics over
the C true channels and grn_stats GRN's channel mean over the 4C true
columns. With zero pads a padded channel of the activation stays 0 through
the whole block, residual included, so the caller pads the activation once
per stage (``convnext_fused.py``) and slices it once. Aligned widths carry no
"c" and run as before. Any H*W: the products' frame-local M tiles mask a
frame's ragged last tile, and no load depends on H*W being aligned.

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
# K2's limit (csrc/convnext_dwln.cuh): the shared memory of a block
SMEM_MAX = 232448


def padded_width(c: int) -> int:
    """The width K2 runs a block of true width c at: c rounded up to 16."""
    return -(-c // 16) * 16


def true_width(p: dict) -> int:
    """The true width of `block_params` p (its padded width where it has no
    pads)."""
    return p.get("c", p["dw"].shape[1])


def block_params(blk) -> dict:
    """A ConvNeXtBlock's parameters in the layout both versions read:
    dw (49, Cp) f32; the pointwise weights in torch Linear layout (out, in),
    bf16; every vector f32. Cp = padded_width(C); where it is not C, every
    entry is zero-padded to Cp channels and 4 * Cp hidden columns, and
    p["c"] is C."""
    c = blk.dwconv.weight.shape[0]
    cp = padded_width(c)
    pad = lambda t, *n: F.pad(t, [q for k in reversed(n) for q in (0, k)]) if any(n) else t
    f32 = lambda t, n: pad(t.detach().float().reshape(-1), n - t.numel()).contiguous()
    bf = lambda t, n, k: pad(t.detach().to(torch.bfloat16), n - t.shape[0],
                             k - t.shape[1]).contiguous()
    p = {
        "dw": pad(blk.dwconv.weight.detach().float().reshape(c, 49).t(), 0, cp - c).contiguous(),
        "dwb": f32(blk.dwconv.bias, cp), "lnw": f32(blk.norm.weight, cp),
        "lnb": f32(blk.norm.bias, cp),
        "w1": bf(blk.pwconv1.weight, 4 * cp, cp),
        "b1": f32(blk.pwconv1.bias, 4 * cp), "gamma": f32(blk.grn.gamma, 4 * cp),
        "beta": f32(blk.grn.beta, 4 * cp),
        "w2": bf(blk.pwconv2.weight, cp, 4 * cp),
        "b2": f32(blk.pwconv2.bias, cp),
    }
    if cp != c:
        p["c"] = c
    return p


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
    """Depthwise 7x7 sum, without its bias, in the order of dwln_row's form
    (csrc/convnext_dwln.cuh): "perdy" per-row partials (K2), "taps" one
    chain with dy outer, "shift" one chain with dx outer, "bf16" bf16
    products and sums. xpad (B, H+6,
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


# the activation after pw1, act<ACT> in csrc/convnext_pw.cuh: erf is the model's GELU
ACTIVATIONS = {
    "erf": F.gelu,
    "none": lambda v: v,
    "tanh": lambda v: 0.5 * v * (1.0 + torch.tanh(0.7978845608 * (v + 0.044715 * v * v * v))),
    "sigmoid": lambda v: v * torch.sigmoid(1.702 * v),
}


def _dwln_padded(xpad: torch.Tensor, p: dict, dw_form: str = "perdy") -> torch.Tensor:
    """dwln on a padded input xpad (B, H+6, W+6, C) whose halo is read as
    it is: depthwise 7x7 + dwb, channel LN (eps 1e-6) over the true
    channels, rounded to bf16 -> A (B*H*W, C) bf16, row-major."""
    acc = dw_plain(xpad, p["dw"], dw_form) + p["dwb"]
    real = acc[..., :true_width(p)]
    mu = real.mean(dim=-1, keepdim=True)
    var = (real - mu).square().mean(dim=-1, keepdim=True)
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


def grn_stats_plain(sums: torch.Tensor, gamma: torch.Tensor, n: int | None = None
                    ) -> torch.Tensor:
    """Plain version of K2's grn_stats: the per-frame sums of squares
    (B, 4C), or the kernel's partials (B, tiles, 4C) reduced in tile order,
    -> gn = gamma * nx (B, 4C) f32 with gx = sqrt(max(s, 1e-12)) and
    nx = gx / (mean_c gx + 1e-6), the mean over the first n (the true 4C,
    default all) columns."""
    if sums.dim() == 3:
        s = sums[:, 0]
        for t in range(1, sums.shape[1]):
            s = s + sums[:, t]
        sums = s
    gx = torch.sqrt(torch.clamp(sums, min=1e-12))
    return gamma * (gx / (gx[:, :n].mean(dim=-1, keepdim=True) + 1e-6))


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
    return pw2_plain(hid, grn_stats_plain(sums, p["gamma"], 4 * true_width(p)), p,
                     xpad[:, 3:3 + h, 3:3 + w], out_dtype)


def convnext_block_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain PyTorch version of K2. x (B, H, W, Cp) f32 or bf16, Cp the
    width of p (its pad channels zero): dwln, pw1, grn_stats and pw2 in
    turn."""
    hid, sums = pw1_plain(dwln_plain(x, p), p, x.shape[0])
    return pw2_plain(hid, grn_stats_plain(sums, p["gamma"], 4 * true_width(p)), p, x, x.dtype)


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


def k3_takes(h: int, w: int, c: int) -> bool:
    """Whether K3 takes frames of h x w x c (c the true width): the rule K2
    had before it took padded widths and any H*W, since K3 has been held bit
    for bit against K2 only on such shapes: c % 16 == 0, H*W % 16 == 0 and
    one image row of dwln's f32 output within shared memory."""
    return not (c % 16 or (h * w) % 16 or 4 * w * c > SMEM_MAX)


def _check(name: str, x: torch.Tensor, params_list, dtypes=(torch.float32, torch.bfloat16)):
    if x.dtype not in dtypes:
        raise TypeError(f"{name} kernel takes {dtypes}, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous 4-d NHWC tensor")
    for p in params_list:
        if x.shape[-1] != p["dw"].shape[1]:
            raise ValueError(f"{name} kernel takes x at the parameters' padded width "
                             f"{p['dw'].shape[1]}, got {x.shape[-1]}")
        for k, v in p.items():
            if torch.is_tensor(v) and (v.device != x.device or not v.is_contiguous()):
                raise ValueError(f"parameter {k} must be contiguous on {x.device}")


def _check_shape(b: int, h: int, w: int, c: int) -> int:
    """K2's shape check (K3's and K8's too), on the padded width c: c % 16
    == 0 (16-byte rows for cp.async and the vector loads) and one image row
    of dwln's f32 output, all channels, within shared memory; any H*W.
    Returns the GEMMs' frame-local M tile: 128 rows where a frame has that
    many, else 64."""
    hw = h * w
    if c % 16 or 4 * w * c > SMEM_MAX:
        raise ValueError(f"convnext_block_fused kernel takes a width C % 16 == 0 (pad it with "
                         f"block_params) and 4*W*C <= {SMEM_MAX} bytes of shared memory, got "
                         f"H={h} W={w} C={c}")
    bm = 128 if hw >= 128 else 64
    if b * -(-hw // bm) > 65535:
        raise ValueError(f"convnext_block_fused kernel takes at most 65535 (frame, M tile) "
                         f"pairs, got {b} frames of {hw} pixels")
    return bm


def k2_parts(x: torch.Tensor, p: dict) -> tuple[list, dict]:
    """K2's four launches on x, in order, as (name, call) pairs over
    buffers allocated here, and the buffers: "a" (dwln's output), "hid" and
    "part" (pw1's), "gn" (grn_stats'), "out" (pw2's). Each call launches its
    kernel and raises if the launch fails."""
    _check("convnext_block_fused", x, [p])
    b, h, w, c = x.shape
    bm = _check_shape(b, h, w, c)
    if x.data_ptr() % 16:
        raise ValueError("convnext_block_fused kernel takes x at a 16-byte aligned address")
    hw, n4, ct = h * w, 4 * c, true_width(p)
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
    pp = {k: p[k].data_ptr() for k in _PARAM_ORDER}

    def dwln():
        _lib.check(getattr(lib, f"vs_cnx_dwln_{sfx}")(
            x.data_ptr(), pp["dw"], pp["dwb"], pp["lnw"], pp["lnb"], ptr["a"], b, h, w, c, ct,
            stream), "vs_cnx_dwln")

    def pw1():
        _lib.check(lib.vs_cnx_pw1(ptr["a"], pp["w1"], pp["b1"], ptr["hid"], ptr["part"], b, hw,
                                  c, bm, stream), "vs_cnx_pw1")

    def grn_stats():
        _lib.check(lib.vs_cnx_grn(ptr["part"], pp["gamma"], ptr["gn"], b, tiles, n4, 4 * ct,
                                  stream), "vs_cnx_grn")

    def pw2():
        _lib.check(getattr(lib, f"vs_cnx_pw2_{sfx}")(
            ptr["hid"], ptr["gn"], pp["beta"], pp["w2"], pp["b2"], x.data_ptr(), ptr["out"], b,
            hw, c, bm, stream), "vs_cnx_pw2")

    return [("dwln", dwln), ("pw1", pw1), ("grn_stats", grn_stats), ("pw2", pw2)], buf


def _launch(x: torch.Tensor, p: dict) -> torch.Tensor:
    """K2: dwln, pw1, grn_stats and pw2, four launches."""
    calls, buf = k2_parts(x, p)
    for _, call in calls:
        call()
    return buf["out"]


def convnext_block_fused(x: torch.Tensor, p: dict) -> torch.Tensor:
    """K2 on `block_params` p, x at p's padded width: the plain version for
    a CPU tensor, the Hopper kernels for a CUDA tensor (which raise on what
    they do not take). One count per call, whatever the launches inside."""
    if x.device.type == "cpu":
        return convnext_block_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_fused: unsupported device {x.device}")
    out = _launch(x, p)
    convnext_block_fused.launches += 1
    return out


def _launch_group(x: torch.Tensor, params_list) -> torch.Tensor:
    """K3: one cooperative launch over K2's buffers, the intermediates in
    (B, H, W, C) bf16 ping-pong buffers; no padded copy."""
    _check("convnext_blocks_fused", x, params_list)
    k = len(params_list)
    if not 1 <= k <= MAX_GROUP:
        raise ValueError(f"convnext_blocks_fused kernel takes 1 to {MAX_GROUP} blocks, got {k}")
    b, h, w, c = x.shape
    if any("c" in p for p in params_list) or not k3_takes(h, w, c):
        raise ValueError(f"convnext_blocks_fused kernel takes C % 16 == 0 (no padded "
                         f"parameters), H*W % 16 == 0 and 4*W*C <= {SMEM_MAX}, got H={h} W={w} "
                         f"C={c}")
    bm = _check_shape(b, h, w, c)
    if x.data_ptr() % 16:
        raise ValueError("convnext_blocks_fused kernel takes x at a 16-byte aligned address")
    hw, dev = h * w, x.device
    pp = torch.empty((min(k - 1, 2), b, h, w, c), dtype=torch.bfloat16, device=dev)
    a = torch.empty((b * hw, c), dtype=torch.bfloat16, device=dev)
    hid = torch.empty((b * hw, 4 * c), dtype=torch.bfloat16, device=dev)
    part = torch.empty((b, -(-hw // bm), 4 * c), dtype=torch.float32, device=dev)
    gn = torch.empty((b, 4 * c), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * (10 * k))(*[p[n].data_ptr() for p in params_list
                                          for n in _PARAM_ORDER])
    sfx = "f32" if x.dtype == torch.float32 else "bf16"
    _lib.check(getattr(_lib.library(), f"vs_cnx_group_{sfx}")(
        x.data_ptr(), out.data_ptr(), pp[0].data_ptr() if k > 1 else None,
        pp[1].data_ptr() if k > 2 else None, a.data_ptr(), hid.data_ptr(), part.data_ptr(),
        gn.data_ptr(), ctypes.addressof(ptrs), k, b, h, w, c, bm, _lib.stream_ptr(x)),
        "vs_cnx_group")
    return out


def group_occupancy(x: torch.Tensor) -> dict:
    """What the occupancy query reports for the K3 instance that x's shape
    and dtype launch: blocks an SM, the grid and the shared memory of a
    block. Runs nothing."""
    b, h, w, c = x.shape
    bm = _check_shape(b, h, w, c)
    info = (ctypes.c_int * 3)()
    sfx = "f32" if x.dtype == torch.float32 else "bf16"
    _lib.check(getattr(_lib.library(), f"vs_cnx_group_{sfx}_info")(b, h, w, c, bm, info),
               "vs_cnx_group_info")
    return {"blocks_per_sm": info[0], "grid": info[1], "smem_bytes": info[2]}


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
