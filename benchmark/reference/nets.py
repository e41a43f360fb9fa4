"""The cards' networks as plain float32 functions of a raw state dict.

Every function reads the weights by their reference names (``embedder.*``,
``detector.*``) from `sd` and computes in float32, whatever dtype the
weights are stored in. Convolutions and dense layers go through an `Ops`
object, so that the control can run the same networks with their operands
rounded to a lower precision (`Fp8Ops`).

* UNet embedder (``unet_*`` cards): ResnetBlocks of two 3x3 conv, BatchNorm
  (eval statistics), activation steps and a 1x1 residual conv; stride-2 3x3
  conv down; the message embedded as the sum of one table row a bit and
  concatenated at the bottleneck; bilinear x2 up, reflect pad, 3x3 conv,
  channel LayerNorm and activation; skips scaled by 2**-0.5; 1x1 out, tanh.
* ConvNeXtV2 extractor: 4x4 stem conv and channel LN; blocks of a 7x7
  depthwise conv, LN, 4x dense, exact GELU, GRN, dense and the residual;
  LN and a 2x2 stride-2 conv between stages; the pixel decoder's 3x3 conv
  (reflect pad), LN and GELU, a spatial mean and the dense head.
* The JND heatmap of the luminance: luminance masking from the 5x5
  weighted mean, contrast masking from the Sobel gradients, both zero
  padded, combined with the overlap term.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .resize import resize


class Ops:
    """float32 convolutions and dense layers."""

    def prep(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.prep(x), self.prep(w), None if b is None else b.float(),
                        stride, padding, 1, groups)

    def linear(self, x, w, b=None):
        return F.linear(self.prep(x), self.prep(w), None if b is None else b.float())


class Fp8Ops(Ops):
    """The same layers with both operands rounded to float8 e4m3, each
    tensor scaled so that its largest magnitude maps to e4m3's largest
    finite value (448), as per-tensor scaled fp8 inference rounds them;
    products and sums in float32."""

    def prep(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "gelu":
        return F.gelu(x)
    if name == "silu":
        return F.silu(x)
    raise NotImplementedError(f"activation {name!r}")


def _ln(x: torch.Tensor, sd: dict, p: str, dim: int) -> torch.Tensor:
    """LayerNorm over axis `dim`, eps 1e-6."""
    mu = x.mean(dim=dim, keepdim=True)
    var = (x - mu).square().mean(dim=dim, keepdim=True)
    shape = [1] * x.ndim
    shape[dim] = -1
    return ((x - mu) / torch.sqrt(var + 1e-6) * sd[p + "weight"].float().reshape(shape)
            + sd[p + "bias"].float().reshape(shape))


def _bn(x: torch.Tensor, sd: dict, p: str) -> torch.Tensor:
    """BatchNorm over NCHW with the stored statistics, eps 1e-5."""
    c = lambda k: sd[p + k].float()[None, :, None, None]
    return (x - c("running_mean")) / torch.sqrt(c("running_var") + 1e-5) * c("weight") + c("bias")


# -- UNet embedder ------------------------------------------------------------

def _resnet_block(x, sd, p, act, ops):
    h = _act(act, _bn(ops.conv2d(x, sd[p + "double_conv.0.weight"], padding=1), sd,
                      p + "double_conv.1."))
    h = _act(act, _bn(ops.conv2d(h, sd[p + "double_conv.3.weight"], padding=1), sd,
                      p + "double_conv.4."))
    return h + ops.conv2d(x, sd[p + "res_conv.weight"], sd[p + "res_conv.bias"])


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of NCHW, no antialias."""
    y = resize(x.permute(0, 2, 3, 1), 2 * x.shape[-2], 2 * x.shape[-1], antialias=False)
    return y.permute(0, 3, 1, 2)


def _reflect1(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


def message_embedding(table: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    """(B, nbits) bits -> (B, hidden): the sum over bits i of row 2 i + bit."""
    nbits = msgs.shape[-1]
    rows = 2 * torch.arange(nbits, device=msgs.device) + msgs.long()
    return table.float()[rows].sum(dim=-2)


def unet(sd: dict, ucfg: dict, x: torch.Tensor, msgs: torch.Tensor, ops: Ops,
         p: str = "embedder.unet.") -> torch.Tensor:
    """x (B, Cin, s, s) in [-1, 1], msgs (B, nbits) -> (B, Cout, s, s)."""
    for key, want in (("normalization", "batch"), ("upsampling_type", "bilinear"),
                      ("downsampling_type", "bilinear")):
        if ucfg.get(key, want) != want:
            raise NotImplementedError(f"the reference UNet takes {key}={want!r}")
    act = ucfg.get("activation", "relu")
    n_down = len(ucfg.get("z_channels_mults", (1, 2, 4, 8))) - 1
    hiddens = [_resnet_block(x, sd, p + "inc.", act, ops)]
    for i in range(n_down):
        q = f"{p}downs.{i}."
        h = ops.conv2d(hiddens[-1], sd[q + "down.weight"], sd[q + "down.bias"], stride=2,
                       padding=1)
        hiddens.append(_resnet_block(h, sd, q + "conv.", act, ops))
    lat = hiddens.pop()
    emb = message_embedding(sd[p + "msg_processor.msg_embeddings.weight"], msgs)
    b, _, hh, ww = lat.shape
    x = torch.cat([lat, emb[:, :, None, None].expand(b, emb.shape[1], hh, ww)], dim=1)
    hiddens.append(x)
    for j in range(ucfg.get("num_blocks", 8)):
        x = _resnet_block(x, sd, f"{p}bottleneck.model.{j}.", act, ops)
    for i in range(n_down):
        q = f"{p}ups.{i}."
        x = torch.cat([x, hiddens.pop() * 2 ** -0.5], dim=1)
        x = ops.conv2d(_reflect1(_up2(x)), sd[q + "up.upsample_block.2.weight"])
        x = _act(act, _ln(x, sd, q + "up.upsample_block.3.", 1))
        x = _resnet_block(x, sd, q + "conv.", act, ops)
    y = ops.conv2d(x, sd[p + "outc.weight"], sd[p + "outc.bias"])
    return torch.tanh(y) if ucfg.get("last_tanh", True) else y


def embedder(sd: dict, card: dict, imgs: torch.Tensor, msgs: torch.Tensor, ops: Ops
             ) -> torch.Tensor:
    """imgs (B, s, s, 3) in [0, 1] -> the watermark prediction (B, s, s, Cout)."""
    if not card["embedder"]["model"].startswith("unet"):
        raise NotImplementedError("the reference embeds with UNet cards only")
    ucfg = card["embedder"]["params"]["unet"]
    if "yuv" in card["embedder"]["model"]:
        imgs = (0.299 * imgs[..., 0] + 0.587 * imgs[..., 1] + 0.114 * imgs[..., 2])[..., None]
    out = unet(sd, ucfg, (imgs * 2 - 1).permute(0, 3, 1, 2), msgs, ops)
    return out.permute(0, 2, 3, 1)


# -- ConvNeXtV2 extractor ---------------------------------------------------------

def extractor_dims(card: dict) -> list[int]:
    """The stage widths: chunkyseal's scale with sqrt(nbits / 128)."""
    params = card["extractor"]["params"]
    dims = list(params["encoder"].get("dims", (96, 192, 384, 768)))
    if params.get("proportional_dim", False):
        mult = math.sqrt(card["args"]["nbits"] / 128)
        dims = [int(d * mult) for d in dims]
    return dims


def stage_shapes(card: dict) -> list[tuple[int, int, int, int]]:
    """(blocks, H, W, C) of each ConvNeXt stage at the processing size."""
    enc = card["extractor"]["params"]["encoder"]
    s = card["args"]["img_size_proc"]
    h = (s - 4) // enc.get("stem_stride", 4) + 1
    out = []
    for i, (d, c) in enumerate(zip(enc.get("depths", (3, 3, 9, 3)), extractor_dims(card))):
        if i:
            h //= 2
        out.append((d, h, h, c))
    return out


def _grn(x: torch.Tensor, sd: dict, p: str) -> torch.Tensor:
    gx = torch.sqrt(torch.clamp(x.square().sum(dim=(-3, -2), keepdim=True), min=1e-12))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return sd[p + "gamma"].float() * (x * nx) + sd[p + "beta"].float() + x


def convnext_block(x: torch.Tensor, sd: dict, p: str, ops: Ops) -> torch.Tensor:
    """x (B, H, W, C) NHWC."""
    c = x.shape[-1]
    h = ops.conv2d(x.permute(0, 3, 1, 2), sd[p + "dwconv.weight"], sd[p + "dwconv.bias"],
                   padding=3, groups=c).permute(0, 2, 3, 1)
    h = ops.linear(_ln(h, sd, p + "norm.", -1), sd[p + "pwconv1.weight"], sd[p + "pwconv1.bias"])
    h = _grn(F.gelu(h), sd, p + "grn.")
    return x + ops.linear(h, sd[p + "pwconv2.weight"], sd[p + "pwconv2.bias"])


def extractor(sd: dict, card: dict, imgs: torch.Tensor, ops: Ops,
              p: str = "detector.") -> torch.Tensor:
    """imgs (B, s, s, 3) in [0, 1] -> logits (B, 1 + nbits)."""
    params = card["extractor"]["params"]
    if not card["extractor"]["model"].startswith("convnext"):
        raise NotImplementedError("the reference detects with ConvNeXt cards only")
    if params.get("pixel_decoder", {}).get("pixelwise", False):
        raise NotImplementedError("the reference takes the global head only")
    enc = params["encoder"]
    q = p + "convnext."
    x = ops.conv2d((imgs * 2 - 1).permute(0, 3, 1, 2), sd[q + "downsample_layers.0.0.weight"],
                   sd[q + "downsample_layers.0.0.bias"], stride=enc.get("stem_stride", 4))
    x = _ln(x, sd, q + "downsample_layers.0.1.", 1).permute(0, 2, 3, 1)
    for i, depth in enumerate(enc.get("depths", (3, 3, 9, 3))):
        if i:
            d = f"{q}downsample_layers.{i}."
            x = _ln(x, sd, d + "0.", -1).permute(0, 3, 1, 2)
            x = ops.conv2d(x, sd[d + "1.weight"], sd[d + "1.bias"], stride=2).permute(0, 2, 3, 1)
        for j in range(depth):
            x = convnext_block(x, sd, f"{q}stages.{i}.{j}.", ops)
    pd = p + "pixel_decoder."
    for k, f in enumerate(params["pixel_decoder"].get("upscale_stages", (4, 2, 2))):
        if f != 1:
            raise NotImplementedError("the reference head takes upscale stages of 1")
        u = f"{pd}output_upscaling.{k}.upsample_block."
        h = ops.conv2d(_reflect1(x.permute(0, 3, 1, 2)), sd[u + "2.weight"])
        x = F.gelu(_ln(h, sd, u + "3.", 1)).permute(0, 2, 3, 1)
    if params["pixel_decoder"].get("sigmoid_output", False):
        raise NotImplementedError("the reference head takes no sigmoid")
    return ops.linear(x.mean(dim=(1, 2)), sd[pd + "linear.weight"], sd[pd + "linear.bias"])


# -- JND ------------------------------------------------------------------------------

_LUM = ((1., 1., 1., 1., 1.),
        (1., 2., 2., 2., 1.),
        (1., 2., 0., 2., 1.),
        (1., 2., 2., 2., 1.),
        (1., 1., 1., 1., 1.))
_SOBEL_X = ((-1., 0., 1.), (-2., 0., 2.), (-1., 0., 1.))
_SOBEL_Y = ((1., 2., 1.), (0., 0., 0.), (-1., -2., -1.))


def _stencil(x: torch.Tensor, k) -> torch.Tensor:
    """Zero-padded 2D cross-correlation of (B, H, W) with kernel k."""
    kt = torch.tensor(k, dtype=x.dtype, device=x.device)[None, None]
    return F.conv2d(x[:, None], kt, padding=kt.shape[-1] // 2)[:, 0]


def jnd_heat(imgs: torch.Tensor) -> torch.Tensor:
    """The luminance JND heatmap, jnd_1_1: (B, H, W, 3) in [0, 1] ->
    (B, H, W, 1) in [0, 1]."""
    x = imgs.float() * 255.0
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    la = _stencil(lum, _LUM) / 32.0
    la = torch.where(la <= 127.0, 17.0 * (1.0 - torch.sqrt(torch.clamp(la, min=0.0) / 127.0 + 1e-5)),
                     3.0 / 128.0 * (la - 127.0) + 3.0)
    gx, gy = _stencil(lum, _SOBEL_X), _stencil(lum, _SOBEL_Y)
    cm = torch.sqrt(torch.clamp(gx * gx + gy * gy, min=1e-12))
    cm = 0.117 * 16.0 * cm ** 2.4 / (cm * cm + 26.0 ** 2)
    heat = torch.clamp(la + cm - 0.3 * torch.minimum(la, cm), min=0.0)
    return (heat / 255.0)[..., None]
