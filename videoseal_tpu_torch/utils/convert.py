"""Weight bridge from the JAX package's variables to the port's state dicts.

`from_jax_variables(embedder_vars, extractor_vars)` takes the nested dicts of
numpy arrays that ``videoseal_tpu`` models hold (``params`` plus
``batch_stats``) and returns the (embedder, extractor) state dicts of the
port's modules, with the reference's torch names and layouts:

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
