"""The serving UNet forward, counterpart of ``videoseal_tpu/kernels/unet_fused.py``.

``UNetMsg`` (``modules/unet.py``) on its own parameters, with eval-mode
BatchNorm folded into the bias-free convs before it (BN(conv(x)) is
conv'(x) + b'), NHWC throughout. ``VideoSeal.with_dtype`` routes a
``UnetEmbedder`` here where ``supports_unet_fused`` holds, as the JAX
package's ``with_dtype`` does; the module stays the training path and the
parity oracle. This is no kernel: the convs are
``F.conv2d`` (cuDNN on the card) on channels_last views of the NHWC
activations, as the JAX package's are ``lax.conv_general_dilated`` outside
any Pallas kernel. ``lane_pack=True`` runs the 3x3 stride-1 convs that
``kernels/lane_pack.supports_lane_pack`` takes as lane-packed 4x4 stride-2
convs (exact; off by default, as in the JAX package). On the card
``with_dtype`` serves the space-to-depth forward of the same function
instead (``kernels/unet_s2d.py``), as the JAX package's does on its
accelerator.

The folded weights are cached on the UNet and rebuilt when any parameter or
buffer (the BatchNorm statistics included) changes storage, dtype, device or
``_version``, as K2's ``kernel_params`` are. The fold runs in the module's
dtype, in the JAX package's order, so a bf16 model folds in bf16 as there.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn

from ..modules.common import ChanRMSNorm, channel_ln
from ..modules.unet import ResnetBlock
from ..ops.resize import resize_bilinear
from .lane_pack import conv3x3_lane_packed, supports_lane_pack


def _conv(x: torch.Tensor, wb: tuple, stride: int = 1, padding: int = 1,
          lane_pack: bool = False) -> torch.Tensor:
    """NHWC conv with an OIHW weight; the bias is added after the conv, in
    x's dtype, as the JAX package adds it. With `lane_pack` a 3x3 stride-1
    SAME conv that `supports_lane_pack` takes runs lane-packed."""
    w, b = wb
    if lane_pack and stride == 1 and padding == 1 and supports_lane_pack(x.shape, w.shape):
        return conv3x3_lane_packed(x, w, b)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride,
                 padding=padding).permute(0, 2, 3, 1)
    return y if b is None else y + b.to(x.dtype)


def _fold_bn(weight: torch.Tensor, bn: nn.BatchNorm2d) -> tuple:
    """conv (no bias) + BatchNorm (eval) -> scaled conv + bias. Exact."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return weight * scale[:, None, None, None], bn.bias - bn.running_mean * scale


def _norm_act(x: torch.Tensor, norm: nn.Module, act: nn.Module) -> torch.Tensor:
    """The norm that does not fold (rms, over channels in float32), then act."""
    if isinstance(norm, ChanRMSNorm):
        gamma = norm.gamma.reshape(-1).float()
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = torch.sqrt((xf * xf).sum(dim=-1, keepdim=True))
        x = ((xf / torch.clamp(n, min=1e-12)) * (x.shape[-1] ** 0.5) * gamma).to(x.dtype)
    return act(x)


def _resnet_block(x: torch.Tensor, blk: ResnetBlock, fp: dict, act: nn.Module,
                  lane_pack: bool = False) -> torch.Tensor:
    dc = blk.double_conv
    h = _norm_act(_conv(x, fp[dc[0]], lane_pack=lane_pack), dc[1], act)
    h = _norm_act(_conv(h, fp[dc[3]], lane_pack=lane_pack), dc[4], act)
    return h + _conv(x, fp[blk.res_conv], padding=0)


def _channel_ln(x: torch.Tensor, ln: nn.Module) -> torch.Tensor:
    return channel_ln(x, ln.weight, ln.bias, -1, eps=1e-6)


def _reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Pad H and W of NHWC input by 1 in ``jnp.pad``'s reflect mode."""
    for d in (1, 2):
        n = x.shape[d]
        lo, hi = (1, n - 2) if n > 1 else (0, 0)
        x = torch.cat([x.narrow(d, lo, 1), x, x.narrow(d, hi, 1)], dim=d)
    return x


def _upsample(x: torch.Tensor, up: nn.Module, fp: dict, act: nn.Module,
              lane_pack: bool = False) -> torch.Tensor:
    """The bilinear Upsample block: 2x resize, reflect pad, valid 3x3 conv
    (lane-packed on the padded input where `lane_pack` is set and
    `supports_lane_pack` takes it), channel LN, act."""
    h, w = x.shape[-3] * 2, x.shape[-2] * 2
    prec = "default" if x.dtype in (torch.bfloat16, torch.float16) else "highest"
    x = _reflect_pad1(resize_bilinear(x, h, w, antialias=False, precision=prec))
    blk = up.upsample_block
    wb = fp[blk[2]]
    if lane_pack and supports_lane_pack((x.shape[0], h, w, x.shape[-1]), wb[0].shape):
        x = conv3x3_lane_packed(x, *wb, prepadded=True)
    else:
        x = _conv(x, wb, padding=0)
    return act(_channel_ln(x, blk[3]))


def fold_params(unet: nn.Module) -> dict:
    """Each conv of `unet` -> (weight, bias or None): the weight OIHW in
    channels_last, a BatchNorm after a bias-free conv folded into it."""
    out = {}
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, nn.Conv2d):
                out[m] = (m.weight, m.bias)
        for m in unet.modules():
            if isinstance(m, ResnetBlock):
                dc = m.double_conv
                for c, n in ((dc[0], dc[1]), (dc[3], dc[4])):
                    if isinstance(n, nn.BatchNorm2d):
                        out[c] = _fold_bn(c.weight, n)
        return {m: (w.detach().contiguous(memory_format=torch.channels_last),
                    None if b is None else b.detach())
                for m, (w, b) in out.items()}


def fused_params(unet: nn.Module) -> dict:
    """`fold_params(unet)`, built once and cached on the UNet. A hit is
    checked against every parameter's and buffer's storage, dtype, device
    and `_version`, so `.to`, `with_dtype`, `load_state_dict` and an
    in-place update fold anew."""
    key = tuple((t.data_ptr(), t.dtype, t.device, t._version)
                for t in itertools.chain(unet.parameters(), unet.buffers()))
    hit = unet.__dict__.get("_fused_params")
    if hit is None or hit[0] != key:
        hit = (key, fold_params(unet))
        unet.__dict__["_fused_params"] = hit
    return hit[1]


def encoder(unet: nn.Module, x: torch.Tensor, fp: dict | None = None,
            lane_pack: bool = False) -> list:
    """The input block and the down levels on NHWC x in [-1, 1] (after the
    embedder's x*2-1): each level's activation, the latent last. `fp` is
    ``fused_params(unet)``, read here when not given."""
    fp = fused_params(unet) if fp is None else fp
    act = unet.inc.double_conv[2]
    hiddens = [_resnet_block(x, unet.inc, fp, act, lane_pack)]
    for d in unet.downs:
        y = _conv(hiddens[-1], fp[d.down], stride=2)
        hiddens.append(_resnet_block(y, d.conv, fp, act, lane_pack))
    return hiddens


def inject(unet: nn.Module, lat: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The (K, hidden) message embedding, cast to the latent's dtype,
    broadcast over the latent and concatenated to it on channels (added,
    where the processor adds)."""
    mp = unet.msg_processor
    e = emb.to(lat.dtype)[:, None, None, :].expand(*lat.shape[:-1], mp.hidden_size)
    return lat + e if mp.msg_agg == "add" else torch.cat([lat, e], dim=-1)


def bottleneck(unet: nn.Module, y: torch.Tensor, fp: dict | None = None,
               lane_pack: bool = False) -> torch.Tensor:
    """The bottleneck's blocks on `inject`'s output."""
    fp = fused_params(unet) if fp is None else fp
    act = unet.inc.double_conv[2]
    for blk in unet.bottleneck.model:
        y = _resnet_block(y, blk, fp, act, lane_pack)
    return y


def decoder(unet: nn.Module, y: torch.Tensor, hiddens: list,
            fp: dict | None = None, lane_pack: bool = False) -> torch.Tensor:
    """The up levels and the output conv. `hiddens` are the skips, popped
    from the end: the encoder's levels with the latent replaced by
    `inject`'s output, the first skip."""
    fp = fused_params(unet) if fp is None else fp
    act = unet.inc.double_conv[2]
    hs = list(hiddens)
    scale = 2 ** -0.5
    for u in unet.ups:
        y = torch.cat([y, hs.pop() * scale], dim=-1)
        y = _upsample(y, u.up, fp, act, lane_pack)
        y = _resnet_block(y, u.conv, fp, act, lane_pack)
    y = _conv(y, fp[unet.outc], padding=0)
    return torch.tanh(y) if unet.last_tanh else y


def unet_apply_fused(unet: nn.Module, x: torch.Tensor, msgs: torch.Tensor,
                     lane_pack: bool = False) -> torch.Tensor:
    """``UNetMsg``'s forward on NHWC input in [0, 1] (the embedder's x*2-1
    preprocess inside) -> NHWC output: `encoder`, `inject`, `bottleneck`,
    `decoder`. The module must be in eval mode and take no gradient: the
    fold reads the running statistics, under no autograd graph.
    `lane_pack`: the small-width 3x3 convs lane-packed (``kernels/lane_pack.py``)."""
    fp = fused_params(unet)
    hiddens = encoder(unet, x * 2 - 1, fp, lane_pack)
    # message injection: the embedding in float32, cast to the latent's dtype
    y = inject(unet, hiddens.pop(), unet.msg_processor.message_embedding(msgs))
    return decoder(unet, bottleneck(unet, y, fp, lane_pack), hiddens + [y], fp, lane_pack)


def supports_unet_fused(unet_cfg: dict) -> bool:
    """The JAX package's rule: batch or rms norms, 2D convs, bilinear up and
    down sampling."""
    return (unet_cfg.get("normalization", "batch") in ("batch", "rms")
            and unet_cfg.get("conv_layer", "conv2d") == "conv2d"
            and unet_cfg.get("upsampling_type", "bilinear") == "bilinear"
            and unet_cfg.get("downsampling_type", "bilinear") == "bilinear")
