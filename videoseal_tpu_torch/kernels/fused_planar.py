"""K1: planar-u8 fused JND + prediction upsample + blend (+ detect downscale).

Replaces ``videoseal_tpu/kernels/fused_planar.py::fused_jnd_blend_planar``.
The CUDA kernel (``csrc/fused_planar.cu``) says what bounds it on the H100 and
how it is laid out. This module holds the planar layout helpers, the planar
resize, the plain PyTorch version of K1 and the wrapper that picks between
plain (CPU tensor) and kernel (CUDA tensor).

Layout (``planar_shape``): image rows at [R0, R0+H), image cols at
[C0, C0+W) of a zero-padded (F, 3, Hp, Wb) u8 buffer, the JAX package's
geometry. The watermarked output is (F, 3, TH*n_tiles, Wq) u8 with the image
at [:H, :W].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.resize import _resize_matrix
from . import _lib

R0 = 28          # top pad rows
C0 = 128         # left pad cols
TH = 96          # output rows per TPU tile; fixes the output height
TIN = 128        # input rows per TPU tile; fixes the buffer height


def planar_geometry(h: int, w: int):
    """(n_tiles, padded_h, padded_w, wq) for an HxW image."""
    n_tiles = -(-h // TH)
    hp = TH * n_tiles + (TIN - TH)
    wq = -(-w // 128) * 128
    return n_tiles, hp, wq + 2 * C0, wq


def planar_shape(f: int, h: int, w: int) -> tuple[int, int, int, int]:
    """Buffer shape (F, 3, Hp, Wb) for F HxW frames."""
    _, hp, wb, _ = planar_geometry(h, w)
    return (f, 3, hp, wb)


def pack_planar(imgs) -> torch.Tensor:
    """(F, H, W, 3) u8 NHWC -> padded planar (F, 3, Hp, Wb) u8."""
    imgs = torch.as_tensor(imgs)
    f, h, w, _ = imgs.shape
    out = torch.zeros(planar_shape(f, h, w), dtype=torch.uint8, device=imgs.device)
    out[:, :, R0:R0 + h, C0:C0 + w] = imgs.permute(0, 3, 1, 2)
    return out


def unpack_planar(imgs_p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Kernel output (F, 3, Ho, Wq) u8 -> (F, H, W, 3) u8 NHWC."""
    return imgs_p[:, :, :h, :w].permute(0, 2, 3, 1)


def _embedded(in_size: int, out_size: int, total: int, offset: int) -> np.ndarray:
    """(out_size, total) resize matrix reading input cols [offset, offset+in_size)."""
    m = np.zeros((out_size, total), np.float32)
    m[:, offset:offset + in_size] = _resize_matrix(in_size, out_size, True)
    return m


def resize_planar(imgs_p: torch.Tensor, h: int, w: int, out_h: int, out_w: int,
                  r0: int = R0, c0: int = C0, precision: str = "highest") -> torch.Tensor:
    """Bilinear+antialias resize out of a padded planar buffer:
    (F, 3, Hp, Wb) u8 -> (F, out_h, out_w, 3) f32 in [0, 1], with the offsets
    folded into the resize matrices.

    "highest": f32 planes and matmuls. "default": the planes are cast to bf16
    (u8 values are exact there), the height matmul runs in bf16 with a bf16
    result, the width matmul sums in f32, as the JAX serving path does."""
    _, _, hp, wb = imgs_p.shape
    dev = imgs_p.device
    mh = torch.as_tensor(_embedded(h, out_h, hp, r0), device=dev)
    mw = torch.as_tensor(_embedded(w, out_w, wb, c0), device=dev)
    if precision == "highest":
        y = mh @ (imgs_p.float() * (1.0 / 255.0))
        y = y @ mw.t()
        return y.permute(0, 2, 3, 1)
    if precision != "default":
        raise ValueError(f"resize_planar supports 'highest' or 'default', got {precision!r}")
    y = mh.to(torch.bfloat16) @ imgs_p.to(torch.bfloat16)
    y = y.float() @ mw.to(torch.bfloat16).float().t()
    return y.permute(0, 2, 3, 1) * (1.0 / 255.0)


# ---------------------------------------------------------------------------
# banded tables for the kernel's products
# ---------------------------------------------------------------------------

# output rows per block of K1 and K4 (csrc/blend_up.cuh)
RS = 32
# width taps the kernels keep in registers; a band that is narrower is padded
# with zero weights, a wider one takes the kernels' general path
WIDTH_TAPS = 2


def _band(m: np.ndarray, min_taps: int = 1):
    """Row-banded form of a (n, k) matrix: per-row start column and the
    `taps` weights from there (taps = widest nonzero span, at least
    min_taps; starts clamped so start + taps <= k, with the weights outside
    a row's span zero)."""
    n, k = m.shape
    nz = m != 0
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, k - 1 - nz[:, ::-1].argmax(axis=1), 0)
    taps = int(max((last - first + 1)[any_nz].max(initial=1), min_taps, 1))
    start = np.minimum(first, k - taps).astype(np.int32)
    idx = start[:, None] + np.arange(taps)[None, :]
    return start, m[np.arange(n)[:, None], idx].astype(np.float32), taps


@functools.lru_cache(maxsize=32)
def _tables_np(s: int, h: int, w: int, hout: int, wq: int, ds: int):
    """The kernels' banded tables: "lift" (hout, s) = _resize_matrix(s, h)
    zero-padded to hout rows; "width" (wq, s) = _resize_matrix(s, w)
    zero-padded to wq rows, at least WIDTH_TAPS taps; with ds, the detect
    downscale's "dw" (ds, w) and "dh" (ds, h) / 255."""
    lift = np.zeros((hout, s), np.float32)
    lift[:h] = _resize_matrix(s, h, True)
    width = np.zeros((wq, s), np.float32)
    width[:w] = _resize_matrix(s, w, True)
    tabs = {"lift": _band(lift), "width": _band(width, WIDTH_TAPS)}
    if ds:
        tabs["dw"] = _band(_resize_matrix(w, ds, True))
        tabs["dh"] = _band(_resize_matrix(h, ds, True) / 255.0)
    return tabs


def _window_ld(nt: int) -> int:
    """Floats in a row of the kernels' luminance window for a band of nt
    threads: 16 * nt columns and a 4-column pad each side, plus 4 floats of
    padding after every 32 (csrc/blend_up.cuh: window_ld)."""
    c = 16 * nt + 8
    return c + 4 * (c >> 5) + 4


@functools.lru_cache(maxsize=32)
def _window_rows(s: int, h: int, hout: int, rs: int = RS) -> int:
    """The most low-res rows a strip of rs output rows lifts from: the rows a
    block of K1 or K4 stages (rows >= h lift from none)."""
    start, _, taps = _tables_np(s, h, h, hout, h, 0)["lift"]
    n = 0
    for y0 in range(0, min(hout, h), rs):
        y1 = min(y0 + rs, h)
        n = max(n, int(start[y1 - 1]) + taps - int(start[y0]))
    return n


@functools.lru_cache(maxsize=32)
def _tables(s, h, w, hout, wq, ds, device: torch.device):
    """`_tables_np` on `device`: f32 lift and width weights, bf16 detect
    weights."""
    out = {}
    for name, (start, wt, taps) in _tables_np(s, h, w, hout, wq, ds).items():
        dt = torch.float32 if name in ("lift", "width") else torch.bfloat16
        out[name] = (torch.as_tensor(start, device=device),
                     torch.as_tensor(wt, device=device).to(dt).contiguous(), taps)
    return out


# ---------------------------------------------------------------------------
# K1: plain version and kernel launch
# ---------------------------------------------------------------------------

def _width_resized(pred_low: torch.Tensor, w: int, wq: int) -> torch.Tensor:
    """tmp = pred_low @ mw^T (s -> W, zero-padded to wq): the plain version's
    dense width resize, which the kernel does from staged low-res rows."""
    mw = torch.as_tensor(_resize_matrix(pred_low.shape[-1], w, True), device=pred_low.device)
    return torch.nn.functional.pad(pred_low.float() @ mw.t(), (0, wq - w))


def _blend_plain(imgs_p, pred_low, si, sw, h, w, hout, wq, ds, lowres):
    dev = imgs_p.device
    tmp = _width_resized(pred_low, w, wq)
    s = tmp.shape[1]
    lift = np.zeros((hout, s), np.float32)
    lift[:h] = _resize_matrix(s, h, True)
    pred = torch.as_tensor(lift, device=dev) @ tmp                 # (F, hout, wq)
    k255sw = float(np.float32(255.0) * np.float32(sw))
    if lowres:
        delta = k255sw * pred
    else:
        rgb = imgs_p[:, :, R0 - 2:R0 + hout + 2, C0 - 2:C0 + wq + 2].float()
        L = 0.299 * rgb[:, 0] + 0.587 * rgb[:, 1] + 0.114 * rgb[:, 2]
        rows = lambda a, i: a[:, i:i + hout]
        cols = lambda a, j: a[:, :, j:j + wq]
        col5 = rows(L, 0) + rows(L, 1) + rows(L, 2) + rows(L, 3) + rows(L, 4)
        col3 = rows(L, 1) + rows(L, 2) + rows(L, 3)
        h5 = cols(col5, 0) + cols(col5, 1) + cols(col5, 2) + cols(col5, 3) + cols(col5, 4)
        h3 = cols(col3, 1) + cols(col3, 2) + cols(col3, 3)
        la = (h5 + h3 - 2.0 * cols(rows(L, 2), 2)) * (1.0 / 32.0)
        lo = 17.0 * (1.0 - torch.sqrt(la * (1.0 / 127.0) + 1e-5))
        hi = (3.0 / 128.0) * (la - 127.0) + 3.0
        la = torch.where(la <= 127.0, lo, hi)
        t = rows(L, 1) + 2.0 * rows(L, 2) + rows(L, 3)
        gx = cols(t, 3) - cols(t, 1)
        sd = rows(L, 1) - rows(L, 3)
        gy = cols(sd, 1) + 2.0 * cols(sd, 2) + cols(sd, 3)
        cm2 = gx * gx + gy * gy
        cm = 16.0 * torch.exp(torch.log(torch.clamp(cm2, min=1e-20)) * 1.2) / (cm2 + 676.0)
        cm = 0.117 * torch.where(cm2 > 0.0, cm, torch.zeros_like(cm))
        heat = torch.clamp(la + cm - 0.3 * torch.minimum(la, cm), min=0.0) * (1.0 / 255.0)
        delta = (k255sw * heat) * pred
    planes = imgs_p[:, :, R0:R0 + hout, C0:C0 + wq].float()
    vals = torch.clamp(torch.round(float(np.float32(si)) * planes + delta[:, None]), 0.0, 255.0)
    out = vals.to(torch.uint8)
    if not ds:
        return out, None
    mwd = np.zeros((wq, ds), np.float32)
    mwd[:w] = _resize_matrix(w, ds, True).T
    mdh = np.zeros((ds, hout), np.float32)
    mdh[:, :h] = _resize_matrix(h, ds, True) / 255.0
    bf = lambda a: torch.as_tensor(a, device=dev).to(torch.bfloat16).float()
    vd = (vals.to(torch.bfloat16).float() @ bf(mwd)).to(torch.bfloat16).float()
    return out, bf(mdh) @ vd


SMEM_MAX = 232448   # shared memory a block may take on the H100


def k1_smem(s: int, h: int, w: int, ds: int, lowres: bool, rs: int = RS) -> int:
    """Bytes of shared memory a block of K1 takes for s-px predictions of
    HxW frames at rs output rows a block (csrc/fused_planar.cu's launch):
    the low-res rows its strip lifts from, the luminance window (full-res
    JND), the detect row and weights (ds > 0). Runs nothing."""
    if rs < 1:
        raise ValueError(f"fused_jnd_blend_planar kernel takes rs >= 1 rows a block, got {rs}")
    n_tiles, _, _, wq = planar_geometry(h, w)
    hout = TH * n_tiles
    nl = _window_rows(s, h, hout, rs)
    nt = min(256, -(-wq // 512) * 32 if ds else wq // 16)
    det_floats = 3 * wq + ds * (_tables_np(s, h, w, hout, wq, ds)["dw"][2] + 1) if ds else 0
    return 4 * (-(-nl * s // 4) * 4 + (0 if lowres else 5 * _window_ld(nt)) + det_floats)


def _blend_cuda(imgs_p, pred_low, si, sw, h, w, hout, wq, ds, lowres, rs=RS):
    if imgs_p.dtype != torch.uint8 or not imgs_p.is_contiguous():
        raise ValueError("fused_jnd_blend_planar kernel takes a contiguous u8 buffer")
    f, _, hp, wb = imgs_p.shape
    s = pred_low.shape[-1]
    if pred_low.shape != (f, s, s):
        raise ValueError(f"fused_jnd_blend_planar: pred_low must be (F, s, s), got "
                         f"{tuple(pred_low.shape)}")
    if ds and wq > 16 * 256:
        raise ValueError(f"fused_jnd_blend_planar kernel takes the detect output for frames "
                         f"up to 4096 wide, got {wq}")
    if ds % 8 or f > 65535 or imgs_p.data_ptr() % 16:
        raise ValueError("fused_jnd_blend_planar kernel takes ds % 8 == 0, at most 65535 "
                         "frames and a 16-byte aligned buffer")
    pred_low = pred_low.float().contiguous()
    dev = imgs_p.device
    tabs = _tables(s, h, w, hout, wq, ds, dev)
    (ls, lw, lt), (ws, ww, wt) = tabs["lift"], tabs["width"]
    smem = k1_smem(s, h, w, ds, lowres, rs)
    if smem > SMEM_MAX:
        raise ValueError(f"fused_jnd_blend_planar kernel: {smem} bytes of shared memory for "
                         f"s={s}, {h}x{w}, rs={rs} exceed the card's {SMEM_MAX}")
    nl = _window_rows(s, h, hout, rs)
    out = torch.empty((f, 3, hout, wq), dtype=torch.uint8, device=dev)
    vd = det = None
    ptr = lambda t: 0 if t is None else t.data_ptr()
    dws = dww = None
    dwt = 0
    if ds:
        vd = torch.empty((f, 3, hout, ds), dtype=torch.bfloat16, device=dev)
        det = torch.empty((f, 3, ds, ds), dtype=torch.float32, device=dev)
        dws, dww, dwt = tabs["dw"]
    lib = _lib.library()
    stream = _lib.stream_ptr(imgs_p)
    _lib.check(lib.vs_blend_planar(
        imgs_p.data_ptr(), pred_low.data_ptr(), ls.data_ptr(), lw.data_ptr(), lt,
        ws.data_ptr(), ww.data_ptr(), wt, out.data_ptr(), ptr(vd), ptr(dws), ptr(dww), dwt,
        f, hp, wb, hout, h, wq, s, ds, int(lowres), rs, nl, float(si), float(sw), stream),
        "vs_blend_planar")
    if ds:
        dhs, dhw, dht = tabs["dh"]
        _lib.check(lib.vs_detect_height(
            vd.data_ptr(), dhs.data_ptr(), dhw.data_ptr(), dht, det.data_ptr(),
            f, hout, ds, stream), "vs_detect_height")
    return out, det


# K1's attribution variants (csrc/fused_planar.cu): the heat of jnd_heat.cuh's
# HeatMode replaced by the window's centre (copy) or the raw stencil sums
ATTRIBUTION_MODES = {"window": 0, "sums": 1, "production": 3}


def blend_planar_attribution(imgs_p: torch.Tensor, pred_low: torch.Tensor, scaling_w: float,
                             scaling_i: float, h: int, w: int, mode: str) -> torch.Tensor:
    """K1's full-resolution branch (no detect output) with its heat cut
    down by `mode` ("window": the rolling window and its barriers only,
    "sums": the stencil sums without the transcendentals, "production"),
    for timing what holds the kernel back. CUDA tensors only; counts no K1
    launch; the output is the blend with that heat, not K1's."""
    hout, wq = _prepare(imgs_p, pred_low, h, w)
    f, _, hp, wb = imgs_p.shape
    s = pred_low.shape[-1]
    if imgs_p.device.type != "cuda" or imgs_p.dtype != torch.uint8 or not imgs_p.is_contiguous():
        raise ValueError("blend_planar_attribution takes a contiguous u8 CUDA buffer")
    pred_low = pred_low.float().contiguous()
    tabs = _tables(s, h, w, hout, wq, 0, imgs_p.device)
    (ls, lw, lt), (ws, ww, wt) = tabs["lift"], tabs["width"]
    out = torch.empty((f, 3, hout, wq), dtype=torch.uint8, device=imgs_p.device)
    _lib.check(_lib.library().vs_blend_planar_attr(
        imgs_p.data_ptr(), pred_low.data_ptr(), ls.data_ptr(), lw.data_ptr(), lt, ws.data_ptr(),
        ww.data_ptr(), wt, out.data_ptr(), f, hp, wb, hout, h, wq, s, RS,
        _window_rows(s, h, hout), float(scaling_i), float(scaling_w), ATTRIBUTION_MODES[mode],
        _lib.stream_ptr(imgs_p)), "vs_blend_planar_attr")
    return out


def _prepare(imgs_p, pred_low, h, w):
    """Checks and the output geometry (TH * n_tiles rows, wq columns)."""
    _, c, hp, wb = imgs_p.shape
    n_tiles, hp_want, wb_want, wq = planar_geometry(h, w)
    if (c, hp, wb) != (3, hp_want, wb_want):
        raise ValueError(f"buffer {tuple(imgs_p.shape)} does not match planar_shape for {h}x{w}")
    if pred_low.device != imgs_p.device:
        raise ValueError("imgs_p and pred_low must be on one device")
    return TH * n_tiles, wq


def fused_jnd_blend_planar(imgs_p: torch.Tensor, pred_low: torch.Tensor,
                           scaling_w: float, scaling_i: float, h: int, w: int,
                           detect_size: int | None = None, lowres: bool = False,
                           rs: int = RS):
    """imgs_p: padded planar (F, 3, Hp, Wb) u8; pred_low: (F, s, s) watermark
    prediction at processing resolution. Returns (F, 3, TH*n_tiles, Wq) u8:

      out = clip(round(si*img + 255*sw*heat*upsample(pred_low)), 0, 255)

    with heat the full-res JND of the frame, or 1 when lowres=True (the
    heatmap is then already in pred_low). detect_size=ds also returns the
    watermarked frames downscaled to (F, 3, ds, ds) f32 in [0, 1].

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    a block for each `rs` output rows (the same output for any rs the
    kernel's shared memory takes: ``evals/planar_probe.py`` sweeps it)."""
    hout, wq = _prepare(imgs_p, pred_low, h, w)
    args = (imgs_p, pred_low, scaling_i, scaling_w, h, w, hout, wq, detect_size or 0, lowres)
    if imgs_p.device.type == "cpu":
        out, det = _blend_plain(*args)
    elif imgs_p.device.type == "cuda":
        out, det = _blend_cuda(*args, rs)
        fused_jnd_blend_planar.launches += 1
    else:
        raise ValueError(f"fused_jnd_blend_planar: unsupported device {imgs_p.device}")
    return (out, det) if detect_size else out


fused_jnd_blend_planar.launches = 0


def fused_jnd_blend_planar_plain(imgs_p, pred_low, scaling_w, scaling_i, h, w,
                                 detect_size=None, lowres=False, rs=RS):
    """The plain version on any device, to hold the kernel against (it has
    no blocks: `rs` is the kernel's alone)."""
    hout, wq = _prepare(imgs_p, pred_low, h, w)
    out, det = _blend_plain(imgs_p, pred_low, scaling_i, scaling_w, h, w, hout, wq,
                            detect_size or 0, lowres)
    return (out, det) if detect_size else out
