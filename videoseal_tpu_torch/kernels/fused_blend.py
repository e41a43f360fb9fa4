"""K4, K5, K6: full-resolution JND on NHWC frames.

Counterpart of ``videoseal_tpu/kernels/fused_blend.py``. The CUDA kernels
(K4: ``csrc/jnd_up.cu`` on ``csrc/blend_up.cuh``, shared with K1; K5, K6:
``csrc/jnd_delta.cu`` and ``.cuh``; the heat in ``csrc/jnd_heat.cuh``) say
what bounds them on the H100 and how they are laid out. This module holds
the plain PyTorch versions, which follow the kernels' formulation (cm2^1.2 as
exp(log(cm2) * 1.2), the luminance weights on the input's scale), and the
wrappers, which take the plain version for a CPU tensor and launch the kernel
for a CUDA tensor, or raise.

  K4 fused_jnd_delta_up(imgs, pred_low, sw) -> sw * heat * upsample(pred_low)
     fused_jnd_blend_up(imgs, pred_low, si, sw): K4's blend mode, the frame
        itself: u8 clip(round(si * v + 255 * delta), 0, 255), f32
        clip(si * v + delta, 0, 1)
  K5 fused_jnd_delta(imgs, pred, sw)         -> sw * heat * pred
  K6 fused_jnd_blend(imgs, preds, si, sw)    -> clip(si * imgs + sw * heat * preds, 0, 1)

The NHWC embed runs K4's blend mode and K6. K5 is K4 without the height
lift, for a full-resolution prediction that the caller holds; no pipeline
path calls it.

The kernels take any H and W. The TPU's tile pickers and VMEM budget are not
carried over; ``supports_fused_blend`` keeps the math conditions only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..modules.jnd import JND
from ..ops.resize import _resize_matrix
from . import _lib
from .fused_planar import RS, _tables, _width_resized, _window_ld, _window_rows

_RGB_W = (0.299, 0.587, 0.114)


def supports_fused_blend(pred_channels: int, attenuation, blending_method: str) -> bool:
    """The configurations K4-K6 compute: jnd_1_1 / jnd_1_3 without the blue
    tint, additive blending, a 1- or 3-channel prediction."""
    return (isinstance(attenuation, JND)
            and attenuation.in_channels == 1
            and attenuation.out_channels in (1, 3)
            and not attenuation.blue
            and blending_method == "additive"
            and pred_channels in (1, 3))


def _lum_weights(imgs: torch.Tensor) -> tuple[float, float, float]:
    """Luminance weights that put the luminance in 0..255: u8 frames as they
    are, [0, 1] floats times 255 (folded into the weights, as the JAX kernels
    do)."""
    sc = 255.0 if imgs.is_floating_point() else 1.0
    return tuple(float(np.float32(c * sc)) for c in _RGB_W)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _luminance(imgs: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) u8 or [0, 1] float -> (F, H, W) f32 luminance in 0..255."""
    c0, c1, c2 = _lum_weights(imgs)
    x = imgs.float()
    return x[..., 0] * c0 + x[..., 1] * c1 + x[..., 2] * c2


def _heat_plain(imgs: torch.Tensor, mode: str = "full_nosqrt") -> torch.Tensor:
    """(F, H, W, 3) u8 or [0, 1] float -> (F, H, W) f32 JND heat in [0, 1],
    in the order of jnd_heat() (csrc/jnd_heat.cuh). mode picks its HeatMode
    for the K7 probe: "full_nosqrt" the production heat (cm2^1.2), "full"
    the same through sqrt(cm2)^2.4, "sums" the raw stencil sums la + cm2."""
    lum = _luminance(imgs)
    _, h, w = lum.shape
    L = F.pad(lum, (2, 2, 2, 2))
    rows = lambda a, i: a[:, i:i + h]
    cols = lambda a, j: a[:, :, j:j + w]
    col5 = rows(L, 0) + rows(L, 1) + rows(L, 2) + rows(L, 3) + rows(L, 4)
    col3 = rows(L, 1) + rows(L, 2) + rows(L, 3)
    h5 = cols(col5, 0) + cols(col5, 1) + cols(col5, 2) + cols(col5, 3) + cols(col5, 4)
    h3 = cols(col3, 1) + cols(col3, 2) + cols(col3, 3)
    la = (h5 + h3 - 2.0 * lum) * (1.0 / 32.0)
    t = rows(L, 1) + 2.0 * rows(L, 2) + rows(L, 3)
    gx = cols(t, 3) - cols(t, 1)
    sd = rows(L, 1) - rows(L, 3)
    gy = cols(sd, 1) + 2.0 * cols(sd, 2) + cols(sd, 3)
    cm2 = gx * gx + gy * gy
    if mode == "sums":
        return la + cm2
    lo = 17.0 * (1.0 - torch.sqrt(la * (1.0 / 127.0) + 1e-5))
    hi = (3.0 / 128.0) * (la - 127.0) + 3.0
    la = torch.where(la <= 127.0, lo, hi)
    if mode == "full":
        cm = torch.sqrt(cm2)
        cm = 16.0 * torch.exp(torch.log(torch.clamp(cm, min=1e-20)) * 2.4) / (cm2 + 676.0)
    elif mode == "full_nosqrt":
        cm = 16.0 * torch.exp(torch.log(torch.clamp(cm2, min=1e-20)) * 1.2) / (cm2 + 676.0)
    else:
        raise ValueError(f"unknown heat mode {mode!r}")
    cm = 0.117 * torch.where(cm2 > 0.0, cm, torch.zeros_like(cm))
    return torch.clamp(la + cm - 0.3 * torch.minimum(la, cm), min=0.0) * (1.0 / 255.0)


def fused_jnd_delta_up_plain(imgs: torch.Tensor, pred_low: torch.Tensor,
                             scaling_w) -> torch.Tensor:
    _, h, w, _ = imgs.shape
    lift = torch.as_tensor(_resize_matrix(pred_low.shape[-2], h, True), device=imgs.device)
    pred = lift @ _width_resized(pred_low, w, w)
    return (float(scaling_w) * _heat_plain(imgs)) * pred


def fused_jnd_blend_up_plain(imgs: torch.Tensor, pred_low: torch.Tensor, scaling_i,
                             scaling_w) -> torch.Tensor:
    """K4's blend mode: the delta's plain version, then the blend the NHWC
    embed ran after it in torch."""
    delta = fused_jnd_delta_up_plain(imgs, pred_low, scaling_w)
    if imgs.is_floating_point():
        return torch.clamp(scaling_i * imgs + delta[..., None], 0.0, 1.0)
    out = imgs.float().mul_(scaling_i)
    out += 255.0 * delta[..., None]
    return out.round_().clamp_(0.0, 255.0).to(torch.uint8)


def fused_jnd_delta_plain(imgs: torch.Tensor, pred: torch.Tensor, scaling_w) -> torch.Tensor:
    return (float(scaling_w) * _heat_plain(imgs)) * pred.float()


def fused_jnd_blend_plain(imgs: torch.Tensor, preds: torch.Tensor, scaling_i,
                          scaling_w) -> torch.Tensor:
    swh = float(scaling_w) * _heat_plain(imgs)
    out = float(scaling_i) * imgs.float() + swh[..., None] * preds.float()
    return torch.clamp(out, 0.0, 1.0).to(imgs.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_frames(name: str, imgs: torch.Tensor, dtypes) -> tuple[int, int, int]:
    if imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"{name}: imgs must be (F, H, W, 3), got {tuple(imgs.shape)}")
    if imgs.dtype not in dtypes or not imgs.is_contiguous():
        raise ValueError(f"{name} kernel takes contiguous {dtypes} frames, got "
                         f"{imgs.dtype} (contiguous={imgs.is_contiguous()})")
    f, h, w, _ = imgs.shape
    if f > 65535:
        raise ValueError(f"{name} kernel takes at most 65535 frames per call, got {f}")
    return f, h, w


def _check_plane(name: str, t: torch.Tensor, shape: tuple, dtypes, device) -> None:
    if tuple(t.shape) != shape or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous {shape} tensor of {dtypes}, got "
                         f"{tuple(t.shape)} {t.dtype} (contiguous={t.is_contiguous()})")
    if t.device != device:
        raise ValueError(f"{name}: all tensors must be on {device}, got {t.device}")


def _up_cuda(imgs, pred_low, scaling_i, scaling_w, blend: bool):
    """K4 (blend=False: the delta; True: the blended frames)."""
    f, h, w = _check_frames("fused_jnd_delta_up", imgs, (torch.uint8, torch.float32))
    s = pred_low.shape[-1]
    if pred_low.shape != (f, s, s) or pred_low.device != imgs.device:
        raise ValueError(f"fused_jnd_delta_up: pred_low must be (F, s, s) on {imgs.device}, "
                         f"got {tuple(pred_low.shape)} on {pred_low.device}")
    pred_low = pred_low.float().contiguous()
    tabs = _tables(s, h, w, h, w, 0, imgs.device)   # K1's lift and width bands
    (ls, lw, lt), (ws, ww, wt) = tabs["lift"], tabs["width"]
    nl = _window_rows(s, h, h)
    nt = min(256, -(-w // 16))
    smem = 4 * (-(-nl * s // 4) * 4 + 5 * _window_ld(nt))
    if smem > 232448 or -(-h // RS) > 65535:
        raise ValueError(f"fused_jnd_delta_up kernel: {smem} bytes of shared memory or "
                         f"{-(-h // RS)} strips for s={s}, {h}x{w}")
    out = (torch.empty_like(imgs) if blend
           else torch.empty((f, h, w), dtype=torch.float32, device=imgs.device))
    _lib.check(_lib.library().vs_jnd_up(
        imgs.data_ptr(), int(imgs.dtype == torch.uint8), pred_low.data_ptr(), ls.data_ptr(),
        lw.data_ptr(), lt, ws.data_ptr(), ww.data_ptr(), wt, out.data_ptr(), int(blend), f, h, w,
        s, RS, nl, *_lum_weights(imgs), float(scaling_i), float(scaling_w),
        _lib.stream_ptr(imgs)), "vs_jnd_up")
    return out


def _delta_up_cuda(imgs, pred_low, scaling_w):
    return _up_cuda(imgs, pred_low, 0.0, scaling_w, blend=False)


def _blend_up_cuda(imgs, pred_low, scaling_i, scaling_w):
    return _up_cuda(imgs, pred_low, scaling_i, scaling_w, blend=True)


def _delta_cuda(imgs, pred, scaling_w):
    f, h, w = _check_frames("fused_jnd_delta", imgs, (torch.uint8, torch.float32))
    _check_plane("fused_jnd_delta", pred, (f, h, w), (torch.float32,), imgs.device)
    out = torch.empty((f, h, w), dtype=torch.float32, device=imgs.device)
    _lib.check(_lib.library().vs_jnd_delta(
        imgs.data_ptr(), int(imgs.dtype == torch.uint8), pred.data_ptr(), out.data_ptr(),
        f, h, w, *_lum_weights(imgs), float(scaling_w), _lib.stream_ptr(imgs)),
        "vs_jnd_delta")
    return out


def _blend_cuda(imgs, preds, scaling_i, scaling_w):
    f, h, w = _check_frames("fused_jnd_blend", imgs, (torch.float32,))
    pc = preds.shape[-1] if preds.dim() == 4 else 0
    if pc not in (1, 3):
        raise ValueError(f"fused_jnd_blend: preds must be (F, H, W, 1|3), got "
                         f"{tuple(preds.shape)}")
    _check_plane("fused_jnd_blend", preds, (f, h, w, pc), (torch.float32, torch.bfloat16),
                 imgs.device)
    out = torch.empty_like(imgs)
    _lib.check(_lib.library().vs_jnd_blend(
        imgs.data_ptr(), preds.data_ptr(), int(preds.dtype == torch.bfloat16), pc,
        out.data_ptr(), f, h, w, *_lum_weights(imgs), float(scaling_i), float(scaling_w),
        _lib.stream_ptr(imgs)), "vs_jnd_blend")
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _dispatch(fn, plain, cuda, imgs, *args):
    """plain on a CPU tensor; on a CUDA tensor the kernel, one more launch
    on fn's count."""
    if imgs.device.type == "cpu":
        return plain(imgs, *args)
    if imgs.device.type != "cuda":
        raise ValueError(f"{fn.__name__}: unsupported device {imgs.device}")
    out = cuda(imgs, *args)
    fn.launches += 1
    return out


def fused_jnd_delta_up(imgs: torch.Tensor, pred_low: torch.Tensor, scaling_w) -> torch.Tensor:
    """K4. imgs (F, H, W, 3) u8 or [0, 1] f32; pred_low (F, s, s) watermark
    prediction at processing resolution. Returns the delta (F, H, W) f32 =
    scaling_w * jnd_heat(imgs) * bilinear_upscale(pred_low), without the
    full-resolution prediction ever being materialised."""
    return _dispatch(fused_jnd_delta_up, fused_jnd_delta_up_plain, _delta_up_cuda, imgs,
                     pred_low, scaling_w)


def fused_jnd_blend_up(imgs: torch.Tensor, pred_low: torch.Tensor, scaling_i,
                       scaling_w) -> torch.Tensor:
    """K4's blend mode. imgs (F, H, W, 3) u8 or [0, 1] f32; pred_low (F, s, s)
    f32. Returns the watermarked frames in imgs' dtype: u8
    clip(round(si * v + 255 * delta), 0, 255), f32 clip(si * v + delta, 0, 1),
    with delta = fused_jnd_delta_up(imgs, pred_low, scaling_w), in one pass
    over the frames. A launch counts on fused_jnd_delta_up.launches."""
    return _dispatch(fused_jnd_delta_up, fused_jnd_blend_up_plain, _blend_up_cuda, imgs,
                     pred_low, scaling_i, scaling_w)


def fused_jnd_delta(imgs: torch.Tensor, pred: torch.Tensor, scaling_w) -> torch.Tensor:
    """K5. imgs (F, H, W, 3) u8 or [0, 1] f32; pred (F, H, W) f32. Returns
    the delta (F, H, W) f32 = scaling_w * jnd_heat(imgs) * pred."""
    return _dispatch(fused_jnd_delta, fused_jnd_delta_plain, _delta_cuda, imgs, pred,
                     scaling_w)


def fused_jnd_blend(imgs: torch.Tensor, preds: torch.Tensor, scaling_i,
                    scaling_w) -> torch.Tensor:
    """K6. imgs (F, H, W, 3) [0, 1] f32; preds (F, H, W, 1|3) f32 or bf16.
    Returns clip(si * imgs + sw * jnd_heat(imgs) * preds, 0, 1) in imgs.dtype,
    NHWC in and out."""
    return _dispatch(fused_jnd_blend, fused_jnd_blend_plain, _blend_cuda, imgs, preds,
                     scaling_i, scaling_w)


fused_jnd_delta_up.launches = 0
fused_jnd_delta.launches = 0
fused_jnd_blend.launches = 0
