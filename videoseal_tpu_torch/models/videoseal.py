"""VideoSeal pipelines, counterpart of ``videoseal_tpu/models/videoseal.py``.

Two paths:
  * NHWC (``VideoSeal.embed / detect / extract_message``): (B|F, H, W, 3)
    frames, float in [0, 1] or u8, in and out. The full-resolution JND runs
    through K4's blend mode (``kernels/fused_blend.fused_jnd_blend_up``) for a 1-channel
    prediction and through K6 (``fused_jnd_blend``) for a 3-channel one on
    float frames; detect goes through K2.
  * planar (``embed_planar / detect_planar / embed_detect_planar``): padded
    planar u8 frames (``kernels/fused_planar.planar_shape``) in, planar u8
    watermarked frames and (F, 1 + nbits) logits out, through K1 and K2.
Every kernel runs as its Hopper kernel on CUDA tensors and as its plain
version on CPU tensors.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..kernels.fused_blend import fused_jnd_blend, fused_jnd_blend_up, supports_fused_blend
from ..kernels.fused_planar import fused_jnd_blend_planar, resize_planar
from ..kernels.unet_fused import supports_unet_fused, unet_apply_fused
from ..kernels.unet_s2d import unet_apply_s2d
from ..modules.common import mixes_frames
from ..modules.convnext import differentiable
from ..modules.discriminator import SNConv2d
from ..modules.jnd import JND, build_attenuation
from ..modules.msg_processor import get_random_msg
from ..ops.color import rgb_to_y
from ..ops.resize import resize_bilinear
from ..utils.checkpoint import load_into
from .blender import blend
from .embedder import EmbedderSpec, UnetEmbedder, build_embedder
from .extractor import ExtractorSpec, build_extractor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline settings. compute_dtype="bfloat16" runs the embedder
    and extractor forwards in bf16 (VideoSeal.with_dtype casts the params);
    resize_precision="default" runs the resizes in bf16. The full-res blend
    math stays float32."""
    img_size: int = 256
    clamp: bool = True
    blending_method: str = "additive"
    chunk_size: int = 32
    step_size: int = 4
    video_mode: str = "repeat"
    lowres_attenuation: bool = False
    yuv: bool = False
    nbits: int = 256
    compute_dtype: str = "float32"
    resize_precision: str = "highest"
    fused_embedder: bool = False   # BN-folded UNet forward (kernels/unet_fused.py)
    s2d_embedder: bool = False     # ... in space-to-depth layouts (kernels/unet_s2d.py)


def s2d_embedder_rule(fused_embedder: bool, img_size: int, device_type: str) -> bool:
    """The JAX package's rule for its space-to-depth embedder: the folded
    route is on, the blend is fused (every backend but the CPU: here, the
    model's parameters are not on the CPU) and the processing size is a
    multiple of 8."""
    return fused_embedder and device_type != "cpu" and img_size % 8 == 0


def _expand_video_mode(preds: torch.Tensor, total_frames: int, step_size: int,
                       video_mode: str) -> torch.Tensor:
    """Expand key-frame predictions to all frames."""
    if step_size == 1:
        return preds[:total_frames]
    n = preds.shape[0]
    if video_mode == "repeat":
        out = torch.repeat_interleave(preds, step_size, dim=0)
    elif video_mode == "alternate":
        out = torch.zeros((n * step_size,) + tuple(preds.shape[1:]),
                          dtype=preds.dtype, device=preds.device)
        out[::step_size] = preds
    elif video_mode == "interpolate":
        alpha = 1.0 - torch.linspace(0.0, 1.0, step_size, device=preds.device)
        start = torch.repeat_interleave(preds[:-1], step_size, dim=0)
        end = torch.repeat_interleave(preds[1:], step_size, dim=0)
        a = alpha.repeat(max(n - 1, 0)).reshape((-1,) + (1,) * (preds.ndim - 1))
        interp = (a * start + (1 - a) * end).to(preds.dtype)
        tail = preds[-1:].expand((n * step_size - interp.shape[0],) + tuple(preds.shape[1:]))
        out = torch.cat([interp, tail], dim=0)
    else:
        raise ValueError(f"Unknown video_mode {video_mode}")
    return out[:total_frames]


def _chunked_apply(fn, xs: tuple, chunk_size: int, pad_last: bool = False) -> torch.Tensor:
    """fn over the leading axis of every tensor in xs, chunk_size at a time.

    With `pad_last` (a model that mixes frames: a temporal or 3D conv,
    temporal attention) a short last chunk of an input longer than one chunk
    is filled up to chunk_size with copies of the input's frame 0 and the
    fill's outputs dropped, as the JAX package's ``lax.map`` over padded
    chunks does: the last real frames then see the same neighbours as there.
    Otherwise the short chunk runs as it is."""
    n = xs[0].shape[0]
    pad = (-n) % chunk_size if pad_last and n > chunk_size else 0
    if pad:
        xs = tuple(torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))]) for a in xs)
    outs = [fn(tuple(a[i:i + chunk_size] for a in xs)) for i in range(0, n + pad, chunk_size)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return out[:n] if pad else out


def _make_run_embedder(embedder, cfg: PipelineConfig, pre_scale: float | None = None):
    """Embedder forward over a (frames, msgs) chunk: optional input rescale
    (1/255 for u8 frames), YUV-Y select, compute-dtype cast, then, where
    cfg.fused_embedder is set, the module is in eval mode and takes no
    gradient, the UNet's space-to-depth forward (``kernels/unet_s2d.py``)
    where cfg.s2d_embedder is set too, else its folded forward
    (``kernels/unet_fused.py``); otherwise the module."""
    cdtype = _DTYPES[cfg.compute_dtype]
    fused = cfg.fused_embedder and isinstance(embedder, UnetEmbedder)

    def run_embedder(batch):
        inp, m = batch
        if pre_scale is not None:
            inp = inp * pre_scale
        x = (rgb_to_y(inp) if cfg.yuv else inp).to(cdtype)
        if fused and not embedder.training and not differentiable(embedder, x):
            if cfg.s2d_embedder:
                return unet_apply_s2d(embedder.unet, x, m)
            return unet_apply_fused(embedder.unet, x, m)
        return embedder(x, m)

    return run_embedder


def embed_pipeline(embedder, attenuation: JND | None, cfg: PipelineConfig,
                   imgs: torch.Tensor, msgs: torch.Tensor, scaling_w: float,
                   scaling_i: float, is_video: bool, lowres_attenuation: bool):
    """NHWC embed. imgs (B|F, H, W, 3) float in [0, 1] or u8; msgs (B, nbits)
    for images, (1, nbits) for video. Returns (imgs_w, preds_w): imgs_w in
    imgs' dtype (u8 rounded and clamped; f32 without clamp when
    cfg.clamp=False), preds_w the full-resolution prediction (F, H, W, C)."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    s = cfg.img_size
    is_u8 = not imgs.is_floating_point()
    run_embedder = _make_run_embedder(embedder, cfg, pre_scale=1.0 / 255.0 if is_u8 else None)
    lowres = attenuation is not None and lowres_attenuation

    with torch.no_grad():
        if is_video:
            # key frames only, unless the lowres heatmap needs every frame
            if lowres:
                imgs_res = resize_bilinear(imgs, s, s, precision=cfg.resize_precision)
                keys = imgs_res[::cfg.step_size]
            else:
                keys = resize_bilinear(imgs[::cfg.step_size], s, s,
                                       precision=cfg.resize_precision)
            key_msgs = msgs[:1].expand(keys.shape[0], msgs.shape[-1])
            preds = _chunked_apply(run_embedder, (keys, key_msgs), cfg.chunk_size,
                                   mixes_frames(embedder))
            preds = _expand_video_mode(preds, imgs.shape[0], cfg.step_size, cfg.video_mode)
        else:
            imgs_res = resize_bilinear(imgs, s, s, precision=cfg.resize_precision)
            preds = _chunked_apply(run_embedder, (imgs_res, msgs), cfg.chunk_size,
                                   mixes_frames(embedder))

    preds = preds.float()  # the full-resolution watermark math stays f32
    if lowres:
        lr = imgs_res.float()
        if is_u8:
            lr = lr * (1.0 / 255.0)
        preds = attenuation.heatmaps(lr) * preds
    preds_full = resize_bilinear(preds, h, w, precision=cfg.resize_precision)
    if attenuation is not None and not lowres:
        if cfg.clamp and supports_fused_blend(preds_full.shape[-1], attenuation,
                                              cfg.blending_method):
            if preds_full.shape[-1] == 1:
                # K4's blend mode: the prediction's upsample, the JND and the
                # RGB blend in one pass over the frames, in their dtype
                return (fused_jnd_blend_up(imgs, preds[..., 0], scaling_i, scaling_w),
                        preds_full)
            if not is_u8:
                return (fused_jnd_blend(imgs, preds_full.contiguous(), scaling_i, scaling_w),
                        preds_full)
        hm_in = imgs.float() * (1.0 / 255.0) if is_u8 else imgs
        preds_full = attenuation.heatmaps(hm_in) * preds_full
    if is_u8:
        x = imgs.float()
        if cfg.blending_method == "additive":
            out = scaling_i * x + 255.0 * scaling_w * preds_full
        else:
            out = 255.0 * blend(cfg.blending_method, x * (1.0 / 255.0), preds_full,
                                scaling_i, scaling_w)
        imgs_w = out.round().clamp(0.0, 255.0).to(torch.uint8) if cfg.clamp else out
        return imgs_w, preds_full
    imgs_w = blend(cfg.blending_method, imgs, preds_full, scaling_i, scaling_w)
    if cfg.clamp:
        imgs_w = torch.clamp(imgs_w, 0.0, 1.0)
    return imgs_w, preds_full


def embed_pipeline_planar(embedder, attenuation: JND, cfg: PipelineConfig,
                          imgs_p: torch.Tensor, msgs: torch.Tensor, scaling_w: float,
                          scaling_i: float, h: int, w: int,
                          with_detect_input: bool = False,
                          lowres_attenuation: bool | None = None):
    """Planar-u8 video embed. Returns planar watermarked frames
    (F, 3, TH*n_tiles, Wq) u8 and, with with_detect_input, the extractor's
    input (F, s, s, 3) f32 in [0, 1] produced inside the blend kernel.

    lowres_attenuation (default cfg's) computes the JND heatmap at processing
    resolution and multiplies it into the prediction before the blend."""
    if attenuation is None or cfg.blending_method != "additive":
        raise ValueError("the planar path needs JND attenuation and additive blending")
    lowres = cfg.lowres_attenuation if lowres_attenuation is None else lowres_attenuation
    s = cfg.img_size
    run_embedder = _make_run_embedder(embedder, cfg)
    if lowres:
        frames_res = resize_planar(imgs_p, h, w, s, s, precision=cfg.resize_precision)
        keys = frames_res[::cfg.step_size]
    else:
        keys = resize_planar(imgs_p[::cfg.step_size], h, w, s, s,
                             precision=cfg.resize_precision)
    key_msgs = msgs[:1].expand(keys.shape[0], msgs.shape[-1])
    with torch.no_grad():
        preds = _chunked_apply(run_embedder, (keys, key_msgs), cfg.chunk_size,
                               mixes_frames(embedder))
    preds = _expand_video_mode(preds, imgs_p.shape[0], cfg.step_size,
                               cfg.video_mode).float()
    if preds.shape[-1] != 1:
        raise ValueError("the planar path expects a 1-channel prediction")
    pred1 = preds[..., 0]
    if lowres:
        if attenuation.in_channels == 1:
            hm1 = attenuation.heatmap_lum(frames_res.float())
        else:
            hm1 = attenuation.heatmaps(frames_res.float())[..., 0]
        pred1 = hm1 * pred1
    if with_detect_input:
        imgs_wp, det = fused_jnd_blend_planar(imgs_p, pred1, scaling_w, scaling_i, h, w,
                                              detect_size=s, lowres=lowres)
        return imgs_wp, det.permute(0, 2, 3, 1)
    return fused_jnd_blend_planar(imgs_p, pred1, scaling_w, scaling_i, h, w,
                                  lowres=lowres)


def _detect_resized(extractor, cfg: PipelineConfig, imgs_res: torch.Tensor) -> torch.Tensor:
    """Extractor over processing-resolution [0,1] NHWC frames -> f32 logits
    (B, 1 + nbits), or a pixelwise extractor's (B, s, s, 1 + nbits)."""
    cdtype = _DTYPES[cfg.compute_dtype]
    with torch.no_grad():
        return _chunked_apply(lambda b: extractor(b[0].to(cdtype)).float(),
                              (imgs_res,), cfg.chunk_size, mixes_frames(extractor))


def detect_pipeline(extractor, cfg: PipelineConfig, imgs: torch.Tensor) -> torch.Tensor:
    """Detect over NHWC frames, float in [0, 1] or u8."""
    s = cfg.img_size
    imgs_res = resize_bilinear(imgs, s, s, precision=cfg.resize_precision)
    if not imgs.is_floating_point():
        imgs_res = imgs_res * (1.0 / 255.0)
    return _detect_resized(extractor, cfg, imgs_res)


def detect_pipeline_planar(extractor, cfg: PipelineConfig, imgs_wp: torch.Tensor,
                           h: int, w: int) -> torch.Tensor:
    """Detect over planar watermarked output (image at rows [0, h), cols [0, w))."""
    s = cfg.img_size
    imgs_res = resize_planar(imgs_wp, h, w, s, s, r0=0, c0=0,
                             precision=cfg.resize_precision)
    return _detect_resized(extractor, cfg, imgs_res)


def aggregate_message(preds: torch.Tensor, aggregation: str = "avg") -> torch.Tensor:
    """(F, 1 + nbits) detector logits -> (1, nbits) int32 bits."""
    bit_preds = preds[:, 1:]
    if aggregation is None or aggregation == "none":
        return bit_preds
    if aggregation == "avg":
        decoded = bit_preds.mean(dim=0)
    elif aggregation == "squared_avg":
        decoded = (bit_preds * bit_preds.abs()).mean(dim=0)
    elif aggregation == "l1norm_avg":
        decoded = (bit_preds * bit_preds.abs().sum(dim=1, keepdim=True)).mean(dim=0)
    elif aggregation == "l2norm_avg":
        wgt = torch.sqrt((bit_preds ** 2).sum(dim=1, keepdim=True))
        decoded = (bit_preds * wgt).mean(dim=0)
    else:
        raise ValueError(f"Unknown aggregation {aggregation}")
    return (decoded > 0)[None].to(torch.int32)


# the deviation of a unit normal truncated at +-2: flax's truncated_normal
# draws divide by it so that the kept values have the asked variance
_TRUNC_STD = 0.87962566103423978


def _fan_in(m: torch.nn.Module) -> int:
    """flax's fan-in of the layer's kernel: kh*kw*I/groups of a conv (kh*kw
    for a depthwise one), kt*kh*kw*I of a 3D conv, I of a dense layer, and
    kh*kw*I of a transposed conv (flax's (kh, kw, I, O) kernel, which the
    port stores as (I, O, kh, kw))."""
    w = m.weight
    if isinstance(m, torch.nn.ConvTranspose2d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def init_weights(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Random init from `generator`, as the JAX package's flax modules draw
    it: conv, 3D conv, transposed conv, spectral-norm conv and linear
    weights lecun_normal (a normal truncated at two deviations, variance
    1 / fan_in) and biases 0; the message table N(0, 1); the spectral norm's
    `u` N(0, 1). Everything else keeps the value its constructor gives, which
    is the JAX module's initializer: norms at scale 1 and bias 0, GRN's
    gamma and beta 0, DINO's layer scales 1 and class token 0, the ViT's
    position and relative-position tables 0; ActNorm sets itself from its
    first batch in train mode. A module with its own
    `init_weights(generator)` (DINO's position table, N(0, 0.02)) draws its
    part."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(generator)
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear,
                              torch.nn.ConvTranspose2d, SNConv2d)):
                torch.nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.mul_(_fan_in(m) ** -0.5 / _TRUNC_STD)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
                if isinstance(m, SNConv2d):
                    m.u.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, torch.nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)


class VideoSeal:
    """The user-facing model: embed / detect / extract_message over NHWC
    frames, and embed_planar / detect_planar / embed_detect_planar over
    padded planar u8 frames."""

    def __init__(self, embedder_spec: EmbedderSpec, extractor_spec: ExtractorSpec,
                 attenuation: JND | None, cfg: PipelineConfig, scaling_w: float = 0.2,
                 scaling_i: float = 1.0, card: dict | None = None, seed: int = 0):
        self.embedder_spec = embedder_spec
        self.extractor_spec = extractor_spec
        self.embedder = embedder_spec.module.eval()
        self.extractor = extractor_spec.module.eval()
        self.attenuation = attenuation
        self.cfg = cfg
        self.scaling_w = scaling_w
        self.scaling_i = scaling_i
        self.card = card or {}
        self.generator = torch.Generator().manual_seed(seed)

    @property
    def device(self) -> torch.device:
        return next(self.embedder.parameters()).device

    @property
    def nbits(self) -> int:
        return self.cfg.nbits

    def get_random_msg(self, bsz: int = 1, nb_repetitions: int = 1) -> torch.Tensor:
        return get_random_msg(self.nbits, bsz, nb_repetitions, self.generator, self.device)

    def _msgs(self, msgs, bsz: int = 1):
        if msgs is None:
            return self.get_random_msg(bsz)
        return torch.as_tensor(msgs, device=self.device)

    # -- NHWC path ----------------------------------------------------------
    def embed(self, imgs, msgs=None, is_video: bool = False,
              lowres_attenuation: bool | None = None) -> dict:
        """imgs (B|F, H, W, 3), float in [0, 1] or u8, moved to the model's
        device. Returns imgs_w (imgs' dtype), preds_w (full-resolution
        prediction) and msgs (one row per frame)."""
        imgs = torch.as_tensor(imgs, device=self.device).contiguous()
        msgs = self._msgs(msgs, 1 if is_video else imgs.shape[0])
        if is_video and msgs.shape[0] != 1:
            raise ValueError("a video takes one message: msgs must have one row")
        lowres = self.cfg.lowres_attenuation if lowres_attenuation is None else lowres_attenuation
        imgs_w, preds_w = embed_pipeline(self.embedder, self.attenuation, self.cfg, imgs, msgs,
                                         self.scaling_w, self.scaling_i, is_video, lowres)
        out_msgs = msgs[:1].expand(imgs.shape[0], msgs.shape[-1]) if is_video else msgs
        return {"imgs_w": imgs_w, "preds_w": preds_w, "msgs": out_msgs}

    def detect(self, imgs, is_video: bool = False) -> dict:
        """imgs (B|F, H, W, 3), float in [0, 1] or u8 -> preds (B|F, 1 + nbits)."""
        imgs = torch.as_tensor(imgs, device=self.device)
        return {"preds": detect_pipeline(self.extractor, self.cfg, imgs)}

    def extract_message(self, imgs, aggregation: str = "avg") -> torch.Tensor:
        """The video's message, (1, nbits) int32, from its frames' logits."""
        preds = self.detect(imgs, is_video=True)["preds"]
        if preds.dim() == 4:  # pixelwise extractor: average spatially first
            preds = preds.mean(dim=(1, 2))
        return aggregate_message(preds, aggregation)

    # -- planar-u8 serving path -------------------------------------------
    @property
    def supports_planar(self) -> bool:
        """Can the padded-planar u8 video path serve this card? It needs JND
        attenuation, additive blending and a 1-channel prediction (the
        production cards videoseal_1.0 and pixelseal)."""
        return (self.attenuation is not None and self.cfg.blending_method == "additive"
                and self.embedder_spec.out_channels == 1)

    def embed_planar(self, imgs_p, h: int, w: int, msgs=None,
                     lowres_attenuation: bool | None = None) -> dict:
        msgs = self._msgs(msgs)
        imgs_w = embed_pipeline_planar(self.embedder, self.attenuation, self.cfg, imgs_p,
                                       msgs, self.scaling_w, self.scaling_i, h, w,
                                       lowres_attenuation=lowres_attenuation)
        return {"imgs_w": imgs_w, "msgs": msgs}

    def detect_planar(self, imgs_wp, h: int, w: int) -> dict:
        return {"preds": detect_pipeline_planar(self.extractor, self.cfg, imgs_wp, h, w)}

    def embed_detect_planar(self, imgs_p, h: int, w: int, msgs=None,
                            lowres_attenuation: bool | None = None,
                            fused_detect: bool | None = None) -> dict:
        """Embed and detect in one serving call. fused_detect (default: follow
        lowres_attenuation) takes the extractor's input from inside the blend
        kernel instead of a separate planar resize of the output."""
        msgs = self._msgs(msgs)
        lowres = self.cfg.lowres_attenuation if lowres_attenuation is None else lowres_attenuation
        fused = lowres if fused_detect is None else fused_detect
        args = (self.embedder, self.attenuation, self.cfg, imgs_p, msgs,
                self.scaling_w, self.scaling_i, h, w)
        if fused:
            if self.cfg.img_size % 128:
                raise ValueError(f"the in-kernel detect path needs img_size % 128 == 0, "
                                 f"got {self.cfg.img_size}; pass fused_detect=False")
            imgs_w, det = embed_pipeline_planar(*args, with_detect_input=True,
                                                lowres_attenuation=lowres)
            preds = _detect_resized(self.extractor, self.cfg, det)
        else:
            imgs_w = embed_pipeline_planar(*args, lowres_attenuation=lowres)
            preds = detect_pipeline_planar(self.extractor, self.cfg, imgs_w, h, w)
        return {"imgs_w": imgs_w, "preds": preds, "msgs": msgs}

    # -- configuration -----------------------------------------------------
    def with_dtype(self, dtype: str = "bfloat16", resize_precision: str = "default"):
        """A copy for serving-speed inference: floating params and the
        forwards in `dtype`, bf16 resizes, and a UNet embedder that
        `supports_unet_fused` served through its folded forward, as the JAX
        package's with_dtype serves it; on the card through the
        space-to-depth forward where `s2d_embedder_rule` says so. The
        full-res blend stays f32."""
        fused_emb = (isinstance(self.embedder, UnetEmbedder)
                     and supports_unet_fused(self.embedder.unet_cfg))
        s2d_emb = s2d_embedder_rule(fused_emb, self.cfg.img_size, self.device.type)
        cfg = dataclasses.replace(self.cfg, compute_dtype=dtype,
                                  resize_precision=resize_precision,
                                  fused_embedder=fused_emb, s2d_embedder=s2d_emb)
        emb = dataclasses.replace(self.embedder_spec,
                                  module=copy.deepcopy(self.embedder).to(_DTYPES[dtype]))
        ext = dataclasses.replace(self.extractor_spec,
                                  module=copy.deepcopy(self.extractor).to(_DTYPES[dtype]))
        out = VideoSeal(emb, ext, self.attenuation, cfg, self.scaling_w, self.scaling_i,
                        self.card)
        out.generator = self.generator
        return out

    def to(self, device) -> "VideoSeal":
        self.embedder.to(device)
        self.extractor.to(device)
        return self

    def state_dict(self) -> dict:
        """Reference-named state dict: embedder.* and detector.*."""
        sd = {f"embedder.{k}": v for k, v in self.embedder.state_dict().items()}
        sd.update({f"detector.{k}": v for k, v in self.extractor.state_dict().items()})
        return sd

    def load_state_dict(self, sd: dict) -> None:
        emb = {k[len("embedder."):]: v for k, v in sd.items() if k.startswith("embedder.")}
        ext = {k[len("detector."):]: v for k, v in sd.items() if k.startswith("detector.")}
        self.embedder.load_state_dict(emb)
        self.extractor.load_state_dict(ext)

    @classmethod
    def from_card(cls, card: dict, checkpoint: str | None = None, device="cuda",
                  seed: int = 0) -> "VideoSeal":
        """Build on `device` (the card unless the caller asks for the CPU),
        at random init from `seed` unless a checkpoint is given: the JAX
        package's native ``.npz`` or a reference-named ``torch.save`` file
        (``utils/checkpoint.load_into``; an http(s) URL is skipped)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VideoSeal.from_card builds on the CUDA device by default and "
                               "none is available; pass device='cpu' to build on the CPU")
        args = card.get("args", {})
        nbits = int(args.get("nbits", 256))
        img_size = int(args.get("img_size_proc", args.get("img_size", 256)))
        emb_cfg, ext_cfg = card["embedder"], card["extractor"]
        embedder_spec = build_embedder(emb_cfg["model"], emb_cfg.get("params", {}), nbits,
                                       float(args.get("hidden_size_multiplier", 2.0)))
        extractor_spec = build_extractor(ext_cfg["model"], ext_cfg.get("params", {}),
                                         img_size, nbits)
        cfg = PipelineConfig(
            img_size=img_size,
            blending_method=args.get("blending_method", "additive"),
            chunk_size=int(args.get("videoseal_chunk_size", args.get("videowam_chunk_size", 32))),
            step_size=int(args.get("videoseal_step_size", args.get("videowam_step_size", 4))),
            video_mode=args.get("video_mode", "repeat"),
            lowres_attenuation=bool(args.get("lowres_attenuation", False)),
            yuv=embedder_spec.yuv, nbits=nbits)
        gen = torch.Generator().manual_seed(seed)
        init_weights(embedder_spec.module, gen)
        init_weights(extractor_spec.module, gen)
        model = cls(embedder_spec, extractor_spec, build_attenuation(args.get("attenuation")),
                    cfg, scaling_w=float(args.get("scaling_w", 1.0)),
                    scaling_i=float(args.get("scaling_i", 1.0)), card=card, seed=seed)
        checkpoint = checkpoint or card.get("checkpoint_path")
        # a URL is skipped, as the JAX package skips it: nothing is fetched
        if checkpoint and not str(checkpoint).startswith(("http://", "https://")):
            load_into(str(checkpoint), model.embedder, model.extractor)
        return model.to(device)
