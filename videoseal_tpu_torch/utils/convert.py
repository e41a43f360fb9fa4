"""Weight bridge between the JAX package's variables and the port's state dicts.

`from_jax_variables(embedder_vars, extractor_vars)` takes the nested dicts of
numpy arrays that ``videoseal_tpu`` models hold (``params`` plus
``batch_stats``) and returns the (embedder, extractor) state dicts of the
port's modules, with the reference's torch names and layouts;
`to_jax_variables` is its exact inverse (``utils/checkpoint.save_npz``
writes what it returns):

  conv kernel HWIO (kh, kw, I, O)      -> OIHW
  3D kernel (kt, kh, kw, I, O)         -> (O, I, kt, kh, kw)
  ConvTranspose (kh, kw, I, O)         -> (I, O, kh, kw)
  depthwise (7, 7, 1, C)               -> (C, 1, 7, 7)  (the same transpose)
  Dense kernel (in, out)               -> Linear weight (out, in)
  BatchNorm scale/bias, mean/var       -> weight/bias, running_mean/running_var
  GroupNorm / LayerNorm scale          -> weight
  ChanRMSNorm gamma (C,)               -> (C, 1, 1)
  GRN gamma/beta (D,)                  -> (1, 1, 1, D)
  ViT pos_embed, rel_pos_h / rel_pos_w -> as they are

Each module's rules follow its parameter tree: ``unet``,
``hidden_encoder``, ``dvmark_encoder`` or a VAE's ``encoder`` and
``decoder`` for the embedder (the UNet's conv_layer from its first conv:
``spatial``/``temporal`` subtrees are conv2p1d, a 5-D kernel conv3d),
``encoder.block_*`` the SAM ViT of videoseal_0.0, ``encoder.cls_token``
DINOv2, ``encoder.stage*`` a ConvNeXtV2 (temporal where ``down1_temporal``
is present), ``hidden_decoder`` HiDDeN's, ``dvmark_decoder`` DVMark's; each
Upsample block's form from its subtree (a bias marks the transposed conv, a
1x1 kernel pixelshuffle). `embedder_from_jax` / `extractor_from_jax` (and
their inverses) convert one module alone.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .checkpoint import SEP, unflatten_tree

# substitutions applied in order to a JAX path joined with "."
_UNET_BASE = [
    (r"^downs_(\d+)\.", r"downs.\1."),
    (r"^bottleneck_(\d+)\.", r"bottleneck.model.\1."),
    (r"^ups_(\d+)\.", r"ups.\1."),
    (r"\.down\.conv\.", ".down.downsample_block.1."),
    (r"\.norm1\.(bn|gn|ln|rms)\.", ".double_conv.1."),
    (r"\.norm2\.(bn|gn|ln|rms)\.", ".double_conv.4."),
    (r"^msg_processor\.msg_embeddings$", "msg_processor.msg_embeddings.weight"),
]
# the ResnetBlocks' Conv*Op layouts, by conv_layer
_UNET_CONV = {
    "conv2d": [(r"\.(conv[12]|res_conv)\.conv\.", lambda m: f".{_RESNET_CONV[m[1]]}.")],
    "conv3d": [(r"\.(conv[12]|res_conv)\.conv\.",
                lambda m: f".{_RESNET_CONV[m[1]]}.conv.")],
    "conv2p1d": [(r"\.(conv[12]|res_conv)\.spatial\.conv\.",
                  lambda m: f".{_RESNET_CONV[m[1]]}.conv."),
                 (r"\.(conv[12])\.temporal\.", lambda m: f".{_RESNET_CONV[m[1]]}.temp_conv.")],
}
_UNET = _UNET_CONV["conv2d"] + _UNET_BASE
_RESNET_CONV = {"conv1": "double_conv.0", "conv2": "double_conv.3", "res_conv": "res_conv"}
_CONVNEXT = [
    (r"^encoder\.stem_conv\.", "convnext.downsample_layers.0.0."),
    (r"^encoder\.stem_norm\.", "convnext.downsample_layers.0.1."),
    (r"^encoder\.down(\d)_norm\.", r"convnext.downsample_layers.\1.0."),
    (r"^encoder\.down(\d)_conv\.", r"convnext.downsample_layers.\1.1."),
    (r"^encoder\.stage(\d)_block(\d+)\.", r"convnext.stages.\1.\2."),
]
# temporal_convs: the downsample conv is a Conv2p1dOp
_CONVNEXT_TEMPORAL = [
    (r"^encoder\.down(\d)_conv\.", r"convnext.downsample_layers.\1.1.conv."),
    (r"^encoder\.down(\d)_temporal\.conv\.", r"convnext.downsample_layers.\1.1.temp_conv."),
]
_PIXEL_DECODER = [
    (r"^pixel_decoder\.up_(\d+)\.", r"pixel_decoder.output_upscaling.\1."),
]
_VIT = [
    (r"^encoder\.patch_embed\.", "image_encoder.patch_embed.proj."),
    (r"^encoder\.pos_embed(_temporal)?$", r"image_encoder.pos_embed\1"),
    (r"^encoder\.block_(\d+)\.", r"image_encoder.blocks.\1."),
    (r"^encoder\.temp_block_(\d+)\.", r"image_encoder.temp_blocks.\1."),
    (r"^encoder\.neck_conv(\d)\.", lambda m: f"image_encoder.neck.{2 * int(m[1]) - 2}."),
    (r"^encoder\.neck_norm(\d)\.", lambda m: f"image_encoder.neck.{2 * int(m[1]) - 1}."),
]
# HiDDeN: a ConvBNRelu's conv and norm are its `layers.0` and `layers.1`
_HIDDEN = [
    (r"^hidden_encoder\.conv_bns_(\d+)\.", r"hidden_encoder.conv_bns.\1."),
    (r"^hidden_decoder\.layers_(\d+)\.", r"hidden_decoder.layers.\1."),
    (r"\.conv\.(kernel|bias)$", r".layers.0.\1"),
    (r"\.norm\.(bn|gn|ln|rms)\.", ".layers.1."),
]
# the VAE embedder: taming's names (``down.{level}.block.{i}``, ``mid.attn_1``, ...)
_VAE = [
    (r"\.(down|up)_(\d+)_(block|attn)_(\d+)\.", r".\1.\2.\3.\4."),
    (r"\.(down|up)_(\d+)_(downsample|upsample)\.", r".\1.\2.\3.conv."),
    (r"\.mid_(block_1|attn_1|block_2)\.", r".mid.\1."),
    (r"^msg_processor\.msg_embeddings$", "msg_processor.msg_embeddings.weight"),
]
# DVMark: the JAX names, each list of convs a ModuleList
_DVMARK = [(r"\.(transform|emb[123])_(\d+)\.", r".\1.\2.")]
# the DINO extractor: DINOv2's names
_DINO = [
    (r"^encoder\.patch_embed\.", "image_encoder.patch_embed.proj."),
    (r"^encoder\.blocks_(\d+)\.ls([12])$", r"image_encoder.blocks.\1.ls\2.gamma"),
    (r"^encoder\.blocks_(\d+)\.mlp_fc([12])\.", r"image_encoder.blocks.\1.mlp.fc\2."),
    (r"^encoder\.blocks_(\d+)\.", r"image_encoder.blocks.\1."),
    (r"^encoder\.", "image_encoder."),
]
_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _up_rules(flat: dict) -> list:
    """Each Upsample block's rule, by the form its subtree shows: a
    transposed conv has a bias, the pixelshuffle conv is 1x1, the
    nearest/bilinear conv 3x3. Transposed kernels are marked ``@T`` for
    `_convert`."""
    rules = []
    for path, a in flat.items():
        if not re.search(r"(^|\.)(up|up_\d+)\.conv\.kernel$", path):
            continue
        head = path[:-len(".conv.kernel")]
        if f"{head}.conv.bias" in flat:
            idx, leaf = (0, 1), "@T"
        else:
            idx, leaf = ((0, 1) if a.shape[:2] == (1, 1) else (2, 3)), ""
        rules += [(rf"^{re.escape(head)}\.conv\.", f"{head}.upsample_block.{idx[0]}{leaf}."),
                  (rf"^{re.escape(head)}\.norm\.", f"{head}.upsample_block.{idx[1]}.")]
    return rules


def _unet_conv(names, ndim) -> str:
    """The UNet's conv_layer, from its first ResnetBlock conv's name and rank."""
    for n in names:
        if re.search(r"conv1\.(spatial|temporal)\.|double_conv\.0\.temp_conv\.", n):
            return "conv2p1d"
        if re.search(r"conv1\.conv\.kernel$|double_conv\.0\.conv\.weight$", n) and ndim(n) == 5:
            return "conv3d"
    return "conv2d"


def _convert(flat: dict, rules: list) -> dict:
    sd = {}
    for path, a in flat.items():
        name = path
        for pat, repl in rules:
            name = re.sub(pat, repl, name)
        head, _, leaf = name.rpartition(".")
        if head.endswith("@T"):   # flax ConvTranspose (kh, kw, I, O) -> (I, O, kh, kw)
            head = head[:-2]
            a = np.transpose(a, (2, 3, 0, 1)) if leaf == "kernel" else a
        elif leaf == "kernel":
            a = (np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4
                 else np.transpose(a, (4, 3, 0, 1, 2)) if a.ndim == 5 else a.T)
        elif name.endswith((".grn.gamma", ".grn.beta")):
            a = a.reshape(1, 1, 1, -1)
        elif re.search(r"\.(double_conv\.[14]|layers\.1)\.gamma$", name):   # ChanRMSNorm
            a = a.reshape(-1, 1, 1)
        name = f"{head}.{_LEAF.get(leaf, leaf)}"
        sd[name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        if leaf == "mean":
            sd[f"{head}.num_batches_tracked"] = torch.tensor(0)
    return sd


def embedder_from_jax(embedder_vars: dict) -> dict:
    """A videoseal_tpu embedder's variables -> the state dict of the port's
    UnetEmbedder, HiddenEmbedder, VAEEmbedder or DVMarkEmbedder (chosen by
    the parameter tree)."""
    params = embedder_vars["params"]
    if "unet" not in params:
        rules = (_HIDDEN if "hidden_encoder" in params
                 else _DVMARK if "dvmark_encoder" in params else _VAE)
        flat = _flatten(params)
        flat.update(_flatten(embedder_vars.get("batch_stats", {})))
        return _convert(flat, rules)
    flat = _flatten(params["unet"])
    flat.update(_flatten(embedder_vars.get("batch_stats", {}).get("unet", {})))
    conv = _unet_conv(flat, lambda n: flat[n].ndim)
    rules = _up_rules(flat) + _UNET_CONV[conv] + _UNET_BASE
    return {f"unet.{k}": v for k, v in _convert(flat, rules).items()}


def extractor_from_jax(extractor_vars: dict) -> dict:
    """A videoseal_tpu extractor's variables -> the state dict of the port's
    ConvnextExtractor, SegmentationExtractor, DinoExtractor, HiddenExtractor
    or DVMarkExtractor (chosen by the parameter tree)."""
    ext = extractor_vars["params"]
    flat = _flatten(ext)
    enc = ext.get("encoder", {})
    if "hidden_decoder" in ext:
        rules = _HIDDEN
    elif "dvmark_decoder" in ext:
        rules = []
    elif "cls_token" in enc:
        rules = _DINO
    elif any(k.startswith("block_") for k in enc):
        rules = _VIT
    else:
        rules = (_CONVNEXT_TEMPORAL if "down1_temporal" in enc else []) + _CONVNEXT
    return _convert(flat, _up_rules(flat) + rules + _PIXEL_DECODER)


def from_jax_variables(embedder_vars: dict, extractor_vars: dict) -> tuple[dict, dict]:
    """(embedder_vars, extractor_vars) of a videoseal_tpu model -> (embedder
    state dict, extractor state dict) of the port's modules."""
    return embedder_from_jax(embedder_vars), extractor_from_jax(extractor_vars)


# the inverse substitutions, applied in order to a port name; a norm's leaf
# and a weight's layout are settled afterwards, by name and rank
_UNET_INV = [
    (r"^downs\.(\d+)\.", r"downs_\1."),
    (r"^bottleneck\.model\.(\d+)\.", r"bottleneck_\1."),
    (r"^ups\.(\d+)\.", r"ups_\1."),
    (r"\.down\.downsample_block\.1\.", ".down.conv."),
    (r"\.double_conv\.1\.", ".norm1.@."),
    (r"\.double_conv\.4\.", ".norm2.@."),
    (r"^msg_processor\.msg_embeddings\.weight$", "msg_processor.msg_embeddings"),
]
_UNET_CONV_INV = {
    "conv2d": [(r"\.(double_conv\.[03]|res_conv)\.",
                lambda m: f".{_RESNET_CONV_INV[m[1]]}.conv.")],
    "conv3d": [(r"\.(double_conv\.[03]|res_conv)\.conv\.",
                lambda m: f".{_RESNET_CONV_INV[m[1]]}.conv.")],
    "conv2p1d": [(r"\.(double_conv\.[03]|res_conv)\.conv\.",
                  lambda m: f".{_RESNET_CONV_INV[m[1]]}.spatial.conv."),
                 (r"\.(double_conv\.[03])\.temp_conv\.",
                  lambda m: f".{_RESNET_CONV_INV[m[1]]}.temporal.")],
}
_RESNET_CONV_INV = {v: k for k, v in _RESNET_CONV.items()}
_CONVNEXT_INV = [
    (r"^convnext\.downsample_layers\.0\.0\.", "encoder.stem_conv."),
    (r"^convnext\.downsample_layers\.0\.1\.", "encoder.stem_norm."),
    (r"^convnext\.downsample_layers\.(\d)\.0\.", r"encoder.down\1_norm."),
    (r"^convnext\.downsample_layers\.(\d)\.1\.temp_conv\.", r"encoder.down\1_temporal.conv."),
    (r"^convnext\.downsample_layers\.(\d)\.1\.(conv\.)?", r"encoder.down\1_conv."),
    (r"^convnext\.stages\.(\d)\.(\d+)\.", r"encoder.stage\1_block\2."),
]
_PIXEL_DECODER_INV = [
    (r"^pixel_decoder\.output_upscaling\.(\d+)\.", r"pixel_decoder.up_\1."),
]
_UP_INV = [
    (r"\.upsample_block\.2\.", ".conv."),
    (r"\.upsample_block\.3\.", ".norm."),
    (r"\.upsample_block\.0\.", ".conv."),
    (r"\.upsample_block\.1\.", ".norm."),
]
_VIT_INV = [
    (r"^image_encoder\.patch_embed\.proj\.", "encoder.patch_embed."),
    (r"^image_encoder\.pos_embed(_temporal)?$", r"encoder.pos_embed\1"),
    (r"^image_encoder\.blocks\.(\d+)\.", r"encoder.block_\1."),
    (r"^image_encoder\.temp_blocks\.(\d+)\.", r"encoder.temp_block_\1."),
    (r"^image_encoder\.neck\.(\d)\.",
     lambda m: f"encoder.neck_{'conv' if int(m[1]) % 2 == 0 else 'norm'}{int(m[1]) // 2 + 1}."),
]
_HIDDEN_INV = [
    (r"^hidden_encoder\.conv_bns\.(\d+)\.", r"hidden_encoder.conv_bns_\1."),
    (r"^hidden_decoder\.layers\.(\d+)\.", r"hidden_decoder.layers_\1."),
    (r"\.layers\.0\.", ".conv."),
    (r"\.layers\.1\.", ".norm.@."),
]
_VAE_INV = [
    (r"\.(down|up)\.(\d+)\.(downsample|upsample)\.conv\.", r".\1_\2_\3."),
    (r"\.(down|up)\.(\d+)\.(block|attn)\.(\d+)\.", r".\1_\2_\3_\4."),
    (r"\.mid\.(block_1|attn_1|block_2)\.", r".mid_\1."),
    (r"^msg_processor\.msg_embeddings\.weight$", "msg_processor.msg_embeddings"),
    (r"^((?:encoder|decoder)\.(?:.*\.)?norm\w*)\.weight$", r"\1.scale"),   # GroupNorm
]
_DVMARK_INV = [(r"\.(transform|emb[123])\.(\d+)\.", r".\1_\2.")]
_DINO_INV = [
    (r"^image_encoder\.patch_embed\.proj\.", "encoder.patch_embed."),
    (r"^image_encoder\.blocks\.(\d+)\.ls([12])\.gamma$", r"encoder.blocks_\1.ls\2"),
    (r"^image_encoder\.blocks\.(\d+)\.mlp\.fc([12])\.", r"encoder.blocks_\1.mlp_fc\2."),
    (r"^image_encoder\.blocks\.(\d+)\.", r"encoder.blocks_\1."),
    (r"^image_encoder\.", "encoder."),
    (r"^(encoder\.(?:.*\.)?norm\d?)\.weight$", r"\1.scale"),   # LayerNorm
]
# the UNet's norm module in the JAX tree, by the card's `normalization`
_NORM_NAMES = {"batch": "bn", "group": "gn", "layer": "ln", "rms": "rms"}


def _invert(sd: dict, rules: list, norm: str = "bn") -> tuple[dict, dict]:
    """Port state dict -> (params, batch_stats) as flat dotted JAX paths."""
    params, stats = {}, {}
    for name, t in sd.items():
        head, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().float().cpu().numpy()
        # a transposed conv: an Upsample's first layer with a bias
        transposed = (re.search(r"\.upsample_block\.0$", head) is not None
                      and f"{head}.bias" in sd)
        path = name
        for pat, repl in rules:
            path = re.sub(pat, repl, path)
        if ".@." in path:   # a norm: BN keeps running statistics, RMS a gamma
            kind = ("bn" if f"{head}.running_mean" in sd
                    else "rms" if leaf == "gamma" else norm)
            path = path.replace(".@.", f".{kind}.")
        jhead, _, leaf = path.rpartition(".")
        if leaf in ("running_mean", "running_var"):
            stats[f"{jhead}.{leaf[len('running_'):]}"] = a
            continue
        if leaf == "weight" and transposed:
            leaf, a = "kernel", np.transpose(a, (2, 3, 0, 1))
        elif leaf == "weight" and a.ndim >= 2:   # conv HWIO / THWIO, Dense (in, out)
            leaf = "kernel"
            a = (np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4
                 else np.transpose(a, (2, 3, 4, 1, 0)) if a.ndim == 5 else a.T)
        elif leaf in ("gamma", "beta") and (jhead.endswith(".grn") or ".rms" in jhead):
            a = a.reshape(-1)
        elif leaf == "weight" and (re.search(r"\.(bn|gn)$", jhead)
                                   or re.search(r"(block_\d+|temp_block)\.norm[12]$", jhead)):
            leaf = "scale"   # flax BatchNorm, GroupNorm and the ViT's LayerNorms
        params[f"{jhead}.{leaf}" if jhead else leaf] = np.array(a, np.float32, order="C")
    return params, stats


def _nest(flat: dict) -> dict:
    return unflatten_tree({k.replace(".", SEP): v for k, v in flat.items()})


def embedder_to_jax(embedder_sd: dict, unet_norm: str = "batch") -> dict:
    """The inverse of `embedder_from_jax`. `unet_norm` (the card's
    ``normalization``) names the UNet's or the HiDDeN encoder's norms where
    the state dict cannot: group and layer norms both hold a weight and a
    bias."""
    norm = _NORM_NAMES[unet_norm.split("_")[0]]
    if not any(k.startswith("unet.") for k in embedder_sd):
        rules = (_HIDDEN_INV if any(k.startswith("hidden_encoder.") for k in embedder_sd)
                 else _DVMARK_INV if any(k.startswith("dvmark_encoder.") for k in embedder_sd)
                 else _VAE_INV)
        params, stats = _invert(embedder_sd, rules, norm)
        emb_vars = {"params": _nest(params)}
        if stats:
            emb_vars["batch_stats"] = _nest(stats)
        return emb_vars
    emb = {k[len("unet."):]: v for k, v in embedder_sd.items()}
    conv = _unet_conv(emb, lambda n: emb[n].dim())
    params, stats = _invert(emb, _UNET_CONV_INV[conv] + _UNET_INV + _UP_INV, norm)
    emb_vars = {"params": {"unet": _nest(params)}}
    if stats:
        emb_vars["batch_stats"] = {"unet": _nest(stats)}
    return emb_vars


def extractor_to_jax(extractor_sd: dict, norm: str = "batch") -> dict:
    """The inverse of `extractor_from_jax`; `norm` names the HiDDeN
    decoder's norms."""
    if any(k.startswith("hidden_decoder.") for k in extractor_sd):
        rules = _HIDDEN_INV
    elif any(k.startswith("dvmark_decoder.") for k in extractor_sd):
        rules = []
    elif "image_encoder.cls_token" in extractor_sd:
        rules = _DINO_INV
    elif any(k.startswith("image_encoder.") for k in extractor_sd):
        rules = _VIT_INV
    else:
        rules = _CONVNEXT_INV
    ext, _ = _invert(extractor_sd, rules + _PIXEL_DECODER_INV + _UP_INV,
                     _NORM_NAMES[norm.split("_")[0]])
    return {"params": _nest(ext)}


def to_jax_variables(embedder_sd: dict, extractor_sd: dict, unet_norm: str = "batch",
                     extractor_norm: str | None = None) -> tuple[dict, dict]:
    """(embedder state dict, extractor state dict) of the port's modules ->
    (embedder_vars, extractor_vars) of a videoseal_tpu model: the inverse of
    `from_jax_variables`. `extractor_norm` defaults to `unet_norm`."""
    return (embedder_to_jax(embedder_sd, unet_norm),
            extractor_to_jax(extractor_sd, extractor_norm or unet_norm))


def disc_from_jax(disc_vars: dict) -> dict:
    """A discriminator's JAX variables (``params``, and for the SN U-Net
    ``batch_stats``: each ``SpectralNorm_i`` holding ``conv<n>/kernel/u`` and
    ``.../sigma``) -> the state dict of ``modules/discriminator.py``'s
    module, whose names are the JAX tree's."""
    sd = {}
    for path, a in _flatten(disc_vars["params"]).items():
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            a, leaf = np.transpose(a, (3, 2, 0, 1)), "weight"
        elif leaf == "scale":                       # GroupNorm
            leaf = "weight"
        sd[f"{head}.{leaf}"] = torch.from_numpy(np.array(a, np.float32, order="C"))
    for stats in disc_vars.get("batch_stats", {}).values():
        for name, a in stats.items():
            conv, _, leaf = name.split("/")
            sd[f"{conv}.{leaf}"] = torch.from_numpy(np.array(a, np.float32))
    return sd


def disc_to_jax(sd: dict) -> dict:
    """The inverse of `disc_from_jax`: a discriminator's state dict -> its
    JAX variables (``batch_stats`` only where it has SN convs)."""
    params, stats = {}, {}
    sn = sorted({k.rpartition(".")[0] for k in sd if k.endswith(".u")},
                key=lambda c: int(c[len("conv"):]))
    for name, t in sd.items():
        head, _, leaf = name.rpartition(".")
        a = t.detach().float().cpu().numpy()
        if leaf in ("u", "sigma"):
            stats.setdefault(f"SpectralNorm_{sn.index(head)}", {})[f"{head}/kernel/{leaf}"] = a
            continue
        if leaf == "weight" and a.ndim == 4:
            a, leaf = np.transpose(a, (2, 3, 1, 0)), "kernel"
        elif leaf == "weight":
            leaf = "scale"
        params.setdefault(head, {})[leaf] = np.array(a, np.float32, order="C")
    return {"params": params, **({"batch_stats": stats} if stats else {})}
