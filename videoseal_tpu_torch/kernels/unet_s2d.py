"""The space-to-depth UNet forward, counterpart of ``videoseal_tpu/kernels/unet_s2d.py``.

``UNetMsg`` on its folded parameters (``kernels/unet_fused.fused_params``)
with each level's activations kept in space-to-depth layout

    s2d(s): (B, H, W, C) -> (B, H/s, W/s, s*s*C),  channel (a*s+b)*C + c

so that the small-width top levels (C=16 at 256^2 and C=32 at 128^2 in
videoseal_1.0) become 64 and 128 channels on a grid s times coarser. The
repack is exact algebra: each conv of the UNet becomes one dense conv on the
cells, whose kernel holds the original weights at computed (cell offset,
phase) positions and zeros elsewhere (``pack_conv``). For a conv of kernel
k, stride t and symmetric pixel padding p from an s2d(s_in) input to an
s2d(s_out) output, output pixel o = s_out*I + a reads input pixel
t*o + dy - p, whose cell offset and phase are divmod(t*a + dy - p, s_in)
relative to cell t*s_out/s_in * I. The Upsample block (2x bilinear resize,
reflect pad, 3x3 conv) is one grid-preserving cell conv too
(``pack_up_conv``), with its four border cell rows and columns, where the
resize's edge weights and the reflect pad change the operator, computed
exactly on the plain operators (``_up_strips``).

The JAX package serves this forward on its accelerator: its ``with_dtype``
sets ``s2d_embedder`` where the folded route is on, the blend is fused and
the processing size is a multiple of 8, and the port's ``with_dtype``
follows that rule on the card as ``models/videoseal.py`` records. This is no
kernel: the convs are ``F.conv2d`` (cuDNN on the card) on channels_last
views of the NHWC cells, as the JAX package's are
``lax.conv_general_dilated`` outside any Pallas kernel.

The cell-space weights are packed once from the fold and cached on the UNet
beside it, under the fold's key (every parameter's and buffer's storage,
dtype, device and ``_version``); the tables the packing and the border
strips read (the upsample's taps, the resize rows) are cached per device and
dtype. JAX's channel concat (a permutation matmul) is a concat of the
phase-major views here, exact; its LayerNorm over the real channels of each
phase (an averaging matmul) is a reshape and a mean, which rounds its sums
in another order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..modules.common import ChanRMSNorm
from ..modules.unet import ResnetBlock
from ..ops.resize import _resize_matrix, resize_bilinear
from .unet_fused import _channel_ln, _norm_act, _reflect_pad1, fused_params

# -- layout helpers ----------------------------------------------------------------


def s2d(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/s, W/s, s*s*C), channel (a*s+b)*C+c."""
    if s == 1:
        return x
    b, h, w, c = x.shape
    x = x.reshape(b, h // s, s, w // s, s, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)


def d2s(y: torch.Tensor, s: int) -> torch.Tensor:
    """The inverse of `s2d`."""
    if s == 1:
        return y
    b, hc, wc, cc = y.shape
    c = cc // (s * s)
    y = y.reshape(b, hc, wc, s, s, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, hc * s, wc * s, c)


def cat_s2d(a: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """Concat two s2d(s) tensors along their real channels, phase-major:
    [(ph)(Ca)] + [(ph)(Cb)] -> [(ph)(Ca+Cb)]. A concat of the (.., s*s, C)
    views, the same values as the JAX package's permutation matmul."""
    if s == 1:
        return torch.cat([a, b], dim=-1)
    ss = s * s
    lead = a.shape[:-1]
    out = torch.cat([a.reshape(*lead, ss, a.shape[-1] // ss),
                     b.reshape(*lead, ss, b.shape[-1] // ss)], dim=-1)
    return out.reshape(*lead, a.shape[-1] + b.shape[-1])


def regrid_s2d(y: torch.Tensor, s_from: int, r: int) -> torch.Tensor:
    """Refine the cell grid: s2d(s_from) on G cells -> s2d(s_from/r) on r*G
    cells, a permutation of the layout alone."""
    if r == 1:
        return y
    b, g, gw, cc = y.shape
    s_new = s_from // r
    c = cc // (s_from * s_from)
    y = y.reshape(b, g, gw, r, s_new, r, s_new, c).permute(0, 1, 3, 2, 5, 4, 6, 7)
    return y.reshape(b, g * r, gw * r, s_new * s_new * c)


# -- constants, per device and dtype ---------------------------------------------------

_CONSTS: dict = {}


def _const(key: tuple, build, device, dtype) -> torch.Tensor:
    """`build()` (a numpy array) as a tensor of `dtype` on `device`, made
    once per (key, device, dtype): no upload on the forward's path."""
    k = (key, torch.device(device), dtype)
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.as_tensor(np.ascontiguousarray(build()), device=device).to(dtype)
    return t


@functools.lru_cache(maxsize=32)
def _up_tap_tensor(s: int) -> np.ndarray:
    """Interior taps of (2x bilinear upsample -> reflect pad -> 3x3 conv
    tap d) as a cell-space tensor g[d, k, b, a]: the weight with which conv
    tap d of output pixel 2s*I + b reads input pixel s*(I + k - 1) + a.

    Read off rows of the resize operator (``ops/resize.py``'s half-pixel
    semantics) at an interior cell of a probe domain, so the composition is
    exact by construction."""
    n = 16 * s
    r = _resize_matrix(n, 2 * n, antialias=False)   # (2n, n)
    j = 4                                            # interior probe cell
    g = np.zeros((3, 3, 2 * s, s), np.float32)
    for d in range(3):
        for k in range(3):
            g[d, k] = r[2 * s * j + d - 1:2 * s * (j + 1) + d - 1, s * (j + k - 1):s * (j + k)]
    return g


# -- the packers ------------------------------------------------------------------------


def pack_conv(w: torch.Tensor, conv_stride: int, s_in: int, s_out: int,
              pad: int | None = None) -> tuple:
    """Embed an OIHW kernel into dense cell-space form.

    Returns (W_cells, cell_stride, cd_min), W_cells of shape
    (s_out^2*Co, s_in^2*Ci, K, K): the JAX package's HWIO pack in torch's
    layout. Requires conv_stride*s_out % s_in == 0. `pad`: the original
    symmetric pixel padding (default (k-1)//2); 0 for a prepadded input.
    With s_in = s_out = 1 the pack is the kernel itself."""
    co, ci, kh, kw = w.shape
    if pad is None:
        pad = (kh - 1) // 2
    if (conv_stride * s_out) % s_in:
        raise ValueError(f"cell stride {conv_stride} * {s_out} / {s_in} is not an integer")
    cell_stride = (conv_stride * s_out) // s_in
    if s_in == s_out == 1:
        return w, cell_stride, -pad
    offs = [conv_stride * a + dy - pad for a in range(s_out) for dy in range(kh)]
    cd_min = min(o // s_in for o in offs)
    k = max(o // s_in for o in offs) - cd_min + 1
    wc = w.new_zeros((s_out * s_out * co, s_in * s_in * ci, k, k))
    for a in range(s_out):
        for b in range(s_out):
            ob = (a * s_out + b) * co
            for dy in range(kh):
                cdy, ay = divmod(conv_stride * a + dy - pad, s_in)
                for dx in range(kw):
                    cdx, ax = divmod(conv_stride * b + dx - pad, s_in)
                    ib = (ay * s_in + ax) * ci
                    wc[ob:ob + co, ib:ib + ci, cdy - cd_min, cdx - cd_min] += w[:, :, dy, dx]
    return wc, cell_stride, cd_min


def pack_up_conv(w: torch.Tensor, s: int) -> torch.Tensor:
    """Compose 2x bilinear upsample + reflect pad + 3x3 conv into ONE dense
    cell-space kernel: s2d(s) on G cells in -> s2d(2s) on the same G cells
    out. OIHW (Co, Ci, 3, 3) -> (4*s*s*Co, s*s*Ci, 3, 3) in float32. Holds
    for interior cells; the border cells take the strips of
    ``_upsample_s2d_composed``."""
    g = _const(("up_taps", s), lambda: _up_tap_tensor(s), w.device, torch.float64)
    wc = torch.einsum("dkba,elfc,oide->bfoacikl", g, g, w.to(torch.float64))
    co, ci = w.shape[0], w.shape[1]
    return wc.reshape(4 * s * s * co, s * s * ci, 3, 3).to(torch.float32)


# -- the cell-space weights, cached on the UNet beside the fold -------------------------------


def s2d_params(unet: nn.Module) -> tuple:
    """(``fused_params(unet)``, a dict of the UNet's cell-space weights): the
    dict is filled as a forward first needs each weight and dropped with the
    fold (under ``fused_params``' key)."""
    fp = fused_params(unet)
    key = unet.__dict__["_fused_params"][0]
    hit = unet.__dict__.get("_s2d_params")
    if hit is None or hit[0] != key:
        hit = (key, {})
        unet.__dict__["_s2d_params"] = hit
    return fp, hit[1]


def _packed(cp: dict, fp: dict, conv: nn.Module, conv_stride: int, s_in: int, s_out: int,
            pad: int | None) -> tuple:
    """(W_cells channels_last, bias tiled over the s_out^2 phases or None,
    cell_stride, cd_min) of one conv, from the cache or packed into it."""
    key = (conv, conv_stride, s_in, s_out, pad)
    hit = cp.get(key)
    if hit is None:
        w, b = fp[conv]
        with torch.no_grad():
            wc, cs, cd_min = pack_conv(w, conv_stride, s_in, s_out, pad)
            bias = None if b is None else b.repeat(s_out * s_out)
        hit = cp[key] = (wc.contiguous(memory_format=torch.channels_last), bias, cs, cd_min)
    return hit


def conv_s2d(x: torch.Tensor, packed: tuple, *, conv_stride: int = 1, s_in: int = 1,
             s_out: int = 1, pad: int | None = None, kh: int = 3) -> torch.Tensor:
    """An original-space conv (`packed` by ``pack_conv``) on an s2d(s_in)
    tensor, giving the s2d(s_out) result. Exact for zero 'SAME'-style
    padding, or pad=0 with a prepadded input, whose original kernel size
    `kh` the output size needs."""
    wc, bias, cstride, cd_min = packed
    k = wc.shape[-1]

    def pads(n_in: int) -> tuple:
        h_pix = n_in * s_in
        h_out = (h_pix - kh) // conv_stride + 1 if pad == 0 else h_pix // conv_stride
        n_out = h_out // s_out
        lo = -cd_min
        return lo, max(cstride * (n_out - 1) + k - 1 - lo - (n_in - 1), 0), n_out

    pl, pr, nh = pads(x.shape[1])
    ql, qr, nw = pads(x.shape[2])
    wc = wc if wc.dtype == x.dtype else wc.to(x.dtype)
    if pr <= pl and qr <= ql:
        # a symmetric pad reads zeros past the right edge where the
        # asymmetric one would: the extra output cells are dropped
        y = F.conv2d(x.permute(0, 3, 1, 2), wc, stride=cstride, padding=(pl, ql))
        if y.shape[-2:] != (nh, nw):
            y = y[:, :, :nh, :nw]
        y = y.permute(0, 2, 3, 1)
    else:
        x = F.pad(x, (0, 0, ql, qr, pl, pr))
        y = F.conv2d(x.permute(0, 3, 1, 2), wc, stride=cstride).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


# -- the UNet's blocks in s2d space ----------------------------------------------------------


def _ln_s2d(x: torch.Tensor, ln: nn.Module, s: int) -> torch.Tensor:
    """ChannelLayerNorm over the real channels of each phase of an s2d(s)
    tensor."""
    if s == 1:
        return _channel_ln(x, ln)
    n, hc, wc, cc = x.shape
    ss = s * s
    return _channel_ln(x.reshape(n, hc, wc, ss, cc // ss), ln).reshape(x.shape)


def _norm_act_s2d(h: torch.Tensor, norm: nn.Module, act: nn.Module, s: int) -> torch.Tensor:
    """`_norm_act` on each phase's real channels: the rms norm over C, not
    over s*s*C; a folded BatchNorm leaves the act alone."""
    if s > 1 and isinstance(norm, ChanRMSNorm):
        n, hc, wc, cc = h.shape
        return _norm_act(h.reshape(n, hc, wc, s * s, cc // (s * s)), norm, act).reshape(h.shape)
    return _norm_act(h, norm, act)


def _block_s2d(x: torch.Tensor, blk: ResnetBlock, fp: dict, cp: dict, act: nn.Module,
               s: int) -> torch.Tensor:
    """ResnetBlock (BatchNorm folded) on an s2d(s) input."""
    dc = blk.double_conv
    h = conv_s2d(x, _packed(cp, fp, dc[0], 1, s, s, None), s_in=s, s_out=s)
    h = _norm_act_s2d(h, dc[1], act, s)
    h = conv_s2d(h, _packed(cp, fp, dc[3], 1, s, s, None), s_in=s, s_out=s)
    h = _norm_act_s2d(h, dc[4], act, s)
    res = conv_s2d(x, _packed(cp, fp, blk.res_conv, 1, s, s, None), s_in=s, s_out=s)
    return h + res


def _upsample_s2d(x: torch.Tensor, up: nn.Module, fp: dict, cp: dict, act: nn.Module,
                  s_in: int, s_out: int) -> torch.Tensor:
    """The Upsample block from s2d(s_in) to s2d(s_out) through plain space:
    d2s, 2x bilinear resize, reflect pad, the 3x3 conv packed to s2d(s_out),
    channel LN, act. (The JAX package zero-pads the padded tensor up to a
    multiple of 16 for its conv emitter and drops the extra cells; the
    values are the same.)"""
    x = d2s(x, s_in)
    h, w = x.shape[-3] * 2, x.shape[-2] * 2
    prec = "default" if x.dtype in (torch.bfloat16, torch.float16) else "highest"
    x = _reflect_pad1(resize_bilinear(x, h, w, antialias=False, precision=prec))
    blk = up.upsample_block
    y = conv_s2d(x, _packed(cp, fp, blk[2], 1, 1, s_out, 0), s_in=1, s_out=s_out, pad=0)
    return act(_ln_s2d(y, blk[3], s_out))


def _reflected(m: np.ndarray, lo: bool, hi: bool) -> np.ndarray:
    """Rows of `m` with the reflect pad's rows added in front (a copy of row
    1) and behind (a copy of the row before the last): the padded product
    as one matrix, each row's sum the unpadded one's."""
    idx = ([1] if lo else []) + list(range(m.shape[0])) + ([m.shape[0] - 2] if hi else [])
    return m[idx]


def _edge_rows(n: int, s: int) -> np.ndarray:
    """(2, 2s+2, 2s): the rows of the 2x resize of n pixels that the first
    and the last output cell row of the composed upsample read, from the
    first and the last two input cells (2s pixels), with the reflect pad's
    row folded in at the image's edge."""
    r = _resize_matrix(n, 2 * n, antialias=False)
    return np.stack([_reflected(r[:2 * s + 1, :2 * s], True, False),
                     _reflected(r[-(2 * s + 1):, -2 * s:], False, True)])


def _strip_conv(v: torch.Tensor, w32: torch.Tensor, b32: torch.Tensor | None,
                s: int, tf32: bool) -> torch.Tensor:
    """The valid 3x3 conv of the padded strips v (2, B, h, w, Ci) in float32,
    plus the bias, in s2d(2s). With `tf32` the conv runs with cuDNN's TF32
    on whatever the global flag says: its 10-bit mantissa is finer than the
    bf16 or fp16 the strips are stored in, and than the bf16 passes of the
    JAX package's default-precision float32 conv on its accelerator, and
    the route's time does not hang on that flag (cuDNN's full float32 convs
    at these shapes are slow: PERF.md)."""
    t, b = v.shape[:2]
    v = v.reshape(t * b, *v.shape[2:]).permute(0, 3, 1, 2)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = old or tf32
    try:
        y = F.conv2d(v, w32).permute(0, 2, 3, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    if b32 is not None:
        y = y + b32
    y = s2d(y, 2 * s)
    return y.reshape(t, b, *y.shape[1:])


def _up_strips(x: torch.Tensor, w32: torch.Tensor, b32: torch.Tensor | None, s: int) -> tuple:
    """The exact border cells of upsample + reflect pad + conv on the plain
    operators in float32: the top and bottom output cell rows (2, B, 1, G,
    4s^2*Co) from two 2-cell-row slices of the input, and the left and
    right output cell columns (2, B, G, 1, 4s^2*Co), corners included, from
    two 2-cell-column slices; each pair batched through one chain of
    products. The reflect pad is folded into the resize matrices' rows. A
    float32 x keeps the global TF32 flag; a bf16 or fp16 x's strip convs
    run in TF32 (`_strip_conv`)."""
    g, gw = x.shape[1], x.shape[2]
    hh, ww, dev, f32 = g * s, gw * s, x.device, torch.float32
    full = lambda n: _const(("strip_full", n), lambda: _reflected(
        _resize_matrix(n, 2 * n, antialias=False), True, True), dev, f32)
    edge = lambda n: _const(("strip_edge", n, s), lambda: _edge_rows(n, s), dev, f32)
    b, c, tf32 = x.shape[0], x.shape[-1] // (s * s), x.dtype != torch.float32
    # (2, B, h, w, Ci): each product a broadcast matmul over the leading dims
    xs = torch.stack([d2s(x[:, :2], s), d2s(x[:, -2:], s)]).float()
    u = torch.matmul(edge(hh)[:, None], xs.reshape(2, b, 2 * s, ww * c))
    u = torch.matmul(full(ww), u.reshape(2, b, -1, ww, c))
    rows = _strip_conv(u, w32, b32, s, tf32)
    xs = torch.stack([d2s(x[:, :, :2], s), d2s(x[:, :, -2:], s)]).float()
    u = torch.matmul(full(hh), xs.reshape(2, b, hh, 2 * s * c))
    u = torch.matmul(edge(ww)[:, None, None], u.reshape(2, b, -1, 2 * s, c))
    cols = _strip_conv(u, w32, b32, s, tf32)
    return rows, cols


def _up_packed(cp: dict, fp: dict, conv: nn.Module, s: int) -> tuple:
    """(the composed cell kernel in the fold's dtype, channels_last; its
    bias tiled over the 4s^2 phases; the fold's kernel and bias in float32
    for the border strips), from the cache or packed into it."""
    key = ("up", conv, s)
    hit = cp.get(key)
    if hit is None:
        w, b = fp[conv]
        with torch.no_grad():
            wc = pack_up_conv(w, s).to(w.dtype).contiguous(memory_format=torch.channels_last)
            hit = cp[key] = (wc, None if b is None else b.repeat(4 * s * s), w.float(),
                             None if b is None else b.float())
    return hit


def _upsample_s2d_composed(x: torch.Tensor, up: nn.Module, fp: dict, cp: dict, act: nn.Module,
                           s_in: int, s_out: int) -> torch.Tensor:
    """The Upsample block as ONE grid-preserving cell conv, s2d(s_in) on G
    cells -> s2d(2*s_in) on G cells, then a layout-only regrid to the next
    level's s2d(s_out). The interior is the packed conv; the border cell
    rows and columns, where the resize's edge weights and the reflect pad
    change the operator, are overwritten with the exact strips (rows first,
    then columns, corners from the columns)."""
    blk = up.upsample_block
    conv = blk[2]
    g, gw = x.shape[1], x.shape[2]
    if (conv.kernel_size != (3, 3) or (2 * s_in) % s_out != 0 or g < 4 or gw < 4):
        return _upsample_s2d(x, up, fp, cp, act, s_in, s_out)
    so = 2 * s_in
    wc, bt, w32, b32 = _up_packed(cp, fp, conv, s_in)
    wc = wc if wc.dtype == x.dtype else wc.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), wc, padding=1).permute(0, 2, 3, 1)
    if bt is not None:
        y = y + bt.to(y.dtype)
    y = y.contiguous()
    rows, cols = _up_strips(x, w32, b32, s_in)
    y[:, :1], y[:, -1:] = rows[0], rows[1]
    y[:, :, :1], y[:, :, -1:] = cols[0], cols[1]
    y = act(_ln_s2d(y, blk[3], so))
    return regrid_s2d(y, so, so // s_out)


# -- the schedule and the forward's stages ---------------------------------------------------------


def s2d_schedule(img_size: int, z_channels: int, mults) -> tuple:
    """Each level's s: the smallest power of 2 with s^2 * C_level >= 64,
    capped so that the cell grids stay >= 8 and divide."""
    sched = []
    size = img_size
    for m in mults:
        c = z_channels * m
        s = 1
        while s * s * c < 64 and size % (2 * s) == 0 and size // (2 * s) >= 8:
            s *= 2
        sched.append(s)
        size //= 2
    return tuple(sched)


def schedule_for(unet: nn.Module, img_size: int, schedule: tuple | None = None) -> tuple:
    """`schedule` (or `s2d_schedule` inferred from the UNet's widths at
    `img_size`), sanitized as the JAX package does: the stride-2 down conv
    from level i to i+1 needs s[i] | 2*s[i+1], so s[i] = min(s[i], 2*s[i+1])
    from the bottom up. A schedule longer than the UNet's levels is cut to
    them, as the JAX package reads only its first ones; a shorter one
    raises."""
    widths = [unet.inc.res_conv.out_channels] + [d.down.out_channels for d in unet.downs]
    if schedule is None:
        z = widths[0]
        schedule = s2d_schedule(img_size, z, [c // z for c in widths])
    if len(schedule) < len(widths):
        raise ValueError(f"schedule {tuple(schedule)} has {len(schedule)} levels; the UNet "
                         f"has {len(widths)}")
    sch = list(schedule[:len(widths)])
    for i in range(len(sch) - 2, -1, -1):
        sch[i] = min(sch[i], 2 * sch[i + 1])
    return tuple(sch)


def encoder(unet: nn.Module, x: torch.Tensor, sch: tuple, fp: dict | None = None,
            cp: dict | None = None) -> list:
    """The input block and the down levels on NHWC x in [-1, 1] (after the
    embedder's x*2-1), level i in s2d(sch[i]): each level's activation, the
    latent last."""
    if fp is None or cp is None:
        fp, cp = s2d_params(unet)
    act = unet.inc.double_conv[2]
    hiddens = [_block_s2d(s2d(x, sch[0]), unet.inc, fp, cp, act, sch[0])]
    for i, d in enumerate(unet.downs):
        y = conv_s2d(hiddens[-1], _packed(cp, fp, d.down, 2, sch[i], sch[i + 1], None),
                     conv_stride=2, s_in=sch[i], s_out=sch[i + 1])
        hiddens.append(_block_s2d(y, d.conv, fp, cp, act, sch[i + 1]))
    return hiddens


def inject(unet: nn.Module, lat: torch.Tensor, emb: torch.Tensor, s: int) -> torch.Tensor:
    """The (K, hidden) message embedding, cast to the latent's dtype,
    broadcast over the s2d(s) latent's cells and phases and concatenated to
    it on the real channels (added, where the processor adds)."""
    mp = unet.msg_processor
    e = emb.to(lat.dtype)[:, None, None, :].expand(*lat.shape[:-1], mp.hidden_size)
    if s > 1:
        e = e.repeat(1, 1, 1, s * s)
    return lat + e if mp.msg_agg == "add" else cat_s2d(lat, e, s)


def bottleneck(unet: nn.Module, y: torch.Tensor, s: int, fp: dict | None = None,
               cp: dict | None = None) -> torch.Tensor:
    """The bottleneck's blocks on `inject`'s s2d(s) output."""
    if fp is None or cp is None:
        fp, cp = s2d_params(unet)
    act = unet.inc.double_conv[2]
    for blk in unet.bottleneck.model:
        y = _block_s2d(y, blk, fp, cp, act, s)
    return y


def up_level(unet: nn.Module, i: int, y: torch.Tensor, skip: torch.Tensor, sch: tuple,
             fp: dict | None = None, cp: dict | None = None) -> torch.Tensor:
    """Up level i: the skip (scaled by 2**-0.5) concatenated in the current
    level's layout, the composed upsample to the next level's, its block."""
    if fp is None or cp is None:
        fp, cp = s2d_params(unet)
    act = unet.inc.double_conv[2]
    n = len(sch)
    s_cur, s_next = sch[n - 1 - i], sch[n - 2 - i]
    u = unet.ups[i]
    y = cat_s2d(y, skip * 2 ** -0.5, s_cur)
    y = _upsample_s2d_composed(y, u.up, fp, cp, act, s_cur, s_next)
    return _block_s2d(y, u.conv, fp, cp, act, s_next)


def outc(unet: nn.Module, y: torch.Tensor, sch: tuple, fp: dict | None = None,
         cp: dict | None = None) -> torch.Tensor:
    """The output 1x1 conv in s2d(sch[0]), back to plain NHWC, tanh."""
    if fp is None or cp is None:
        fp, cp = s2d_params(unet)
    y = conv_s2d(y, _packed(cp, fp, unet.outc, 1, sch[0], sch[0], None), s_in=sch[0],
                 s_out=sch[0])
    y = d2s(y, sch[0])
    return torch.tanh(y) if unet.last_tanh else y


def decoder(unet: nn.Module, y: torch.Tensor, hiddens: list, sch: tuple,
            fp: dict | None = None, cp: dict | None = None) -> torch.Tensor:
    """The up levels and the output conv. `hiddens` are the skips, popped
    from the end: the encoder's levels with the latent replaced by
    `inject`'s output, the first skip."""
    if fp is None or cp is None:
        fp, cp = s2d_params(unet)
    hs = list(hiddens)
    for i in range(len(unet.ups)):
        y = up_level(unet, i, y, hs.pop(), sch, fp, cp)
    return outc(unet, y, sch, fp, cp)


def unet_apply_s2d(unet: nn.Module, x: torch.Tensor, msgs: torch.Tensor,
                   schedule: tuple | None = None) -> torch.Tensor:
    """``UNetMsg``'s forward on NHWC input in [0, 1] (the embedder's x*2-1
    inside) -> NHWC output, with per-level s2d layouts: `encoder`, `inject`,
    `bottleneck`, `decoder`. `schedule` is each level's s (inferred from
    the widths at x's size when None, then sanitized). The same function as
    ``unet_fused.unet_apply_fused`` on other operand layouts. The module
    must be in eval mode and take no gradient."""
    sch = schedule_for(unet, x.shape[-3], schedule)
    fp, cp = s2d_params(unet)
    hiddens = encoder(unet, x * 2 - 1, sch, fp, cp)
    y = inject(unet, hiddens.pop(), unet.msg_processor.message_embedding(msgs), sch[-1])
    return decoder(unet, bottleneck(unet, y, sch[-1], fp, cp), hiddens + [y], sch, fp, cp)
