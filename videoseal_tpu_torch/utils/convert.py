"""Weight bridge between the JAX package's variables and the port's state dicts.

`from_jax_variables(embedder_vars, extractor_vars)` takes the nested dicts of
numpy arrays that ``videoseal_tpu`` models hold (``params`` plus
``batch_stats``) and returns the (embedder, extractor) state dicts of the
port's modules, with the reference's torch names and layouts;
`to_jax_variables` is its exact inverse (``utils/checkpoint.save_npz``
writes what it returns):

  conv kernel HWIO (kh, kw, I, O)      -> OIHW
  depthwise (7, 7, 1, C)               -> (C, 1, 7, 7)  (the same transpose)
  Dense kernel (in, out)               -> Linear weight (out, in)
  BatchNorm scale/bias, mean/var       -> weight/bias, running_mean/running_var
  GroupNorm / LayerNorm scale          -> weight
  ChanRMSNorm gamma (C,)               -> (C, 1, 1)
  GRN gamma/beta (D,)                  -> (1, 1, 1, D)
  ViT pos_embed, rel_pos_h / rel_pos_w -> as they are

The extractor's rules follow its parameter tree: ``encoder.block_*`` is the
SAM ViT of videoseal_0.0, ``encoder.stage*`` a ConvNeXtV2.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .checkpoint import SEP, unflatten_tree

# substitutions applied in order to a JAX path joined with "."
_UNET = [
    (r"^downs_(\d+)\.", r"downs.\1."),
    (r"^bottleneck_(\d+)\.", r"bottleneck.model.\1."),
    (r"^ups_(\d+)\.", r"ups.\1."),
    (r"\.norm1\.(bn|gn|ln|rms)\.", ".double_conv.1."),
    (r"\.norm2\.(bn|gn|ln|rms)\.", ".double_conv.4."),
    (r"\.conv1\.conv\.", ".double_conv.0."),
    (r"\.conv2\.conv\.", ".double_conv.3."),
    (r"\.res_conv\.conv\.", ".res_conv."),
    (r"\.up\.conv\.", ".up.upsample_block.2."),
    (r"\.up\.norm\.", ".up.upsample_block.3."),
    (r"^msg_processor\.msg_embeddings$", "msg_processor.msg_embeddings.weight"),
]
_CONVNEXT = [
    (r"^encoder\.stem_conv\.", "convnext.downsample_layers.0.0."),
    (r"^encoder\.stem_norm\.", "convnext.downsample_layers.0.1."),
    (r"^encoder\.down(\d)_norm\.", r"convnext.downsample_layers.\1.0."),
    (r"^encoder\.down(\d)_conv\.", r"convnext.downsample_layers.\1.1."),
    (r"^encoder\.stage(\d)_block(\d+)\.", r"convnext.stages.\1.\2."),
]
_PIXEL_DECODER = [
    (r"^pixel_decoder\.up_(\d+)\.conv\.", r"pixel_decoder.output_upscaling.\1.upsample_block.2."),
    (r"^pixel_decoder\.up_(\d+)\.norm\.", r"pixel_decoder.output_upscaling.\1.upsample_block.3."),
]
_VIT = [
    (r"^encoder\.patch_embed\.", "image_encoder.patch_embed.proj."),
    (r"^encoder\.pos_embed$", "image_encoder.pos_embed"),
    (r"^encoder\.block_(\d+)\.", r"image_encoder.blocks.\1."),
    (r"^encoder\.neck_conv(\d)\.", lambda m: f"image_encoder.neck.{2 * int(m[1]) - 2}."),
    (r"^encoder\.neck_norm(\d)\.", lambda m: f"image_encoder.neck.{2 * int(m[1]) - 1}."),
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


def _convert(flat: dict, rules: list) -> dict:
    sd = {}
    for path, a in flat.items():
        name = path
        for pat, repl in rules:
            name = re.sub(pat, repl, name)
        head, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
        elif name.endswith((".grn.gamma", ".grn.beta")):
            a = a.reshape(1, 1, 1, -1)
        elif re.search(r"\.double_conv\.[14]\.gamma$", name):   # ChanRMSNorm
            a = a.reshape(-1, 1, 1)
        name = f"{head}.{_LEAF.get(leaf, leaf)}"
        sd[name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        if leaf == "mean":
            sd[f"{head}.num_batches_tracked"] = torch.tensor(0)
    return sd


def from_jax_variables(embedder_vars: dict, extractor_vars: dict) -> tuple[dict, dict]:
    """(embedder_vars, extractor_vars) of a videoseal_tpu model -> (embedder
    state dict, extractor state dict) of the port's UnetEmbedder and its
    ConvnextExtractor or SegmentationExtractor (chosen by the extractor's
    parameter tree)."""
    flat = _flatten(embedder_vars["params"]["unet"])
    flat.update(_flatten(embedder_vars.get("batch_stats", {}).get("unet", {})))
    emb = {f"unet.{k}": v for k, v in _convert(flat, _UNET).items()}
    ext = extractor_vars["params"]
    vit = any(k.startswith("block_") for k in ext.get("encoder", {}))
    return emb, _convert(_flatten(ext), (_VIT if vit else _CONVNEXT) + _PIXEL_DECODER)


# the inverse substitutions, applied in order to a port name; a norm's leaf
# and a weight's layout are settled afterwards, by name and rank
_UNET_INV = [
    (r"^downs\.(\d+)\.", r"downs_\1."),
    (r"^bottleneck\.model\.(\d+)\.", r"bottleneck_\1."),
    (r"^ups\.(\d+)\.", r"ups_\1."),
    (r"\.double_conv\.1\.", ".norm1.@."),
    (r"\.double_conv\.4\.", ".norm2.@."),
    (r"\.double_conv\.0\.", ".conv1.conv."),
    (r"\.double_conv\.3\.", ".conv2.conv."),
    (r"\.res_conv\.", ".res_conv.conv."),
    (r"\.up\.upsample_block\.2\.", ".up.conv."),
    (r"\.up\.upsample_block\.3\.", ".up.norm."),
    (r"^msg_processor\.msg_embeddings\.weight$", "msg_processor.msg_embeddings"),
]
_CONVNEXT_INV = [
    (r"^convnext\.downsample_layers\.0\.0\.", "encoder.stem_conv."),
    (r"^convnext\.downsample_layers\.0\.1\.", "encoder.stem_norm."),
    (r"^convnext\.downsample_layers\.(\d)\.0\.", r"encoder.down\1_norm."),
    (r"^convnext\.downsample_layers\.(\d)\.1\.", r"encoder.down\1_conv."),
    (r"^convnext\.stages\.(\d)\.(\d+)\.", r"encoder.stage\1_block\2."),
]
_PIXEL_DECODER_INV = [
    (r"^pixel_decoder\.output_upscaling\.(\d+)\.upsample_block\.2\.",
     r"pixel_decoder.up_\1.conv."),
    (r"^pixel_decoder\.output_upscaling\.(\d+)\.upsample_block\.3\.",
     r"pixel_decoder.up_\1.norm."),
]
_VIT_INV = [
    (r"^image_encoder\.patch_embed\.proj\.", "encoder.patch_embed."),
    (r"^image_encoder\.pos_embed$", "encoder.pos_embed"),
    (r"^image_encoder\.blocks\.(\d+)\.", r"encoder.block_\1."),
    (r"^image_encoder\.neck\.(\d)\.",
     lambda m: f"encoder.neck_{'conv' if int(m[1]) % 2 == 0 else 'norm'}{int(m[1]) // 2 + 1}."),
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
        path = name
        for pat, repl in rules:
            path = re.sub(pat, repl, path)
        if ".@." in path:   # a UNet norm: BN keeps running statistics, RMS a gamma
            kind = ("bn" if f"{head}.running_mean" in sd
                    else "rms" if leaf == "gamma" else norm)
            path = path.replace(".@.", f".{kind}.")
        jhead, _, leaf = path.rpartition(".")
        if leaf in ("running_mean", "running_var"):
            stats[f"{jhead}.{leaf[len('running_'):]}"] = a
            continue
        if leaf == "weight" and a.ndim >= 2:   # conv HWIO, Dense (in, out)
            leaf = "kernel"
            a = np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T
        elif leaf in ("gamma", "beta") and (jhead.endswith(".grn") or ".rms" in jhead):
            a = a.reshape(-1)
        elif leaf == "weight" and (re.search(r"\.(bn|gn)$", jhead)
                                   or re.search(r"\.block_\d+\.norm[12]$", jhead)):
            leaf = "scale"   # flax BatchNorm, GroupNorm and the ViT's LayerNorms
        params[f"{jhead}.{leaf}" if jhead else leaf] = np.array(a, np.float32, order="C")
    return params, stats


def _nest(flat: dict) -> dict:
    return unflatten_tree({k.replace(".", SEP): v for k, v in flat.items()})


def to_jax_variables(embedder_sd: dict, extractor_sd: dict,
                     unet_norm: str = "batch") -> tuple[dict, dict]:
    """(embedder state dict, extractor state dict) of the port's modules ->
    (embedder_vars, extractor_vars) of a videoseal_tpu model: the inverse of
    `from_jax_variables`. `unet_norm` (the card's ``normalization``) names
    the UNet's norms where the state dict cannot: group and layer norms both
    hold a weight and a bias."""
    emb = {k[len("unet."):]: v for k, v in embedder_sd.items() if k.startswith("unet.")}
    params, stats = _invert(emb, _UNET_INV, _NORM_NAMES[unet_norm.split("_")[0]])
    emb_vars = {"params": {"unet": _nest(params)}}
    if stats:
        emb_vars["batch_stats"] = {"unet": _nest(stats)}
    vit = any(k.startswith("image_encoder.") for k in extractor_sd)
    ext, _ = _invert(extractor_sd, (_VIT_INV if vit else _CONVNEXT_INV) + _PIXEL_DECODER_INV)
    return emb_vars, {"params": _nest(ext)}


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
