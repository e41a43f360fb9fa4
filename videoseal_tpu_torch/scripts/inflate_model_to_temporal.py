"""Inflate a 2D checkpoint to a temporal (2+1D) one, counterpart of
``videoseal_tpu/scripts/inflate_model_to_temporal.py``.

Works on the ``.npz`` the port and the JAX package write (numpy only, no
model is built). Every UNet ResnetBlock conv (``conv1``, ``conv2``,
``res_conv``) takes the conv2p1d layout: its 2D conv under ``spatial``
and, for a kernel larger than 1x1, a ``temporal`` k x 1 x 1 kernel that is
the identity over time (centre tap I, the others 0), so the inflated
embedder computes exactly what the 2D one did until temporal fine-tuning
moves it. The other convs (``downs_*/down``, ``outc``, the upsample
convs) and the extractor stay as they are.

The file's training args (``__args__``) are carried over; where they name
an embedder preset with a ``_2p1d`` counterpart (``unet_small2_yuv_quant``),
they name that one instead, so ``videoseal_tpu_torch.load(out.npz)`` builds
the inflated model.

    python -m videoseal_tpu_torch.scripts.inflate_model_to_temporal in.npz out.npz \
        [--temporal_kernel_size 3]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .. import presets
from ..utils.checkpoint import SEP, flatten_tree, load_npz


def _identity_temporal_kernel(channels: int, k: int = 3) -> np.ndarray:
    """(k, 1, 1, C, C) conv kernel acting as the identity over time."""
    w = np.zeros((k, 1, 1, channels, channels), np.float32)
    w[k // 2, 0, 0] = np.eye(channels, dtype=np.float32)
    return w


def inflate_tree(tree: dict, temporal_kernel_size: int = 3) -> dict:
    """Rewrite each ResnetBlock's conv2d subtree {conv: {kernel, ...}} into
    the conv2p1d layout {spatial: {conv: ...}, temporal: {kernel: identity}}
    (no temporal kernel for a 1x1 conv)."""
    out = {}
    for k, v in tree.items():
        is_conv_op = (isinstance(v, dict) and isinstance(v.get("conv"), dict)
                      and np.asarray(v["conv"].get("kernel", np.zeros(()))).ndim == 4)
        if is_conv_op and k in ("conv1", "conv2", "res_conv"):
            kernel = np.asarray(v["conv"]["kernel"])
            out[k] = {"spatial": v}
            if kernel.shape[0] != 1:
                out[k]["temporal"] = {"kernel": _identity_temporal_kernel(
                    kernel.shape[-1], temporal_kernel_size)}
        elif isinstance(v, dict):
            out[k] = inflate_tree(v, temporal_kernel_size)
        else:
            out[k] = v
    return out


def inflate_args(args: dict) -> dict:
    """The training args with the embedder preset's _2p1d counterpart."""
    name = f"{args.get('embedder_model') or presets.EMBEDDER['model']}_2p1d"
    return dict(args, embedder_model=name) if name in presets.EMBEDDER else dict(args)


def inflate(src: str, dst: str, temporal_kernel_size: int = 3) -> None:
    emb, ext = load_npz(src)
    emb = {c: inflate_tree(t, temporal_kernel_size) for c, t in emb.items()}
    flat = {f"embedder{SEP}{k}": v for k, v in flatten_tree(emb).items()}
    flat.update({f"extractor{SEP}{k}": v for k, v in flatten_tree(ext).items()})
    with np.load(src) as data:
        if "__args__" in data.files:
            args = inflate_args(json.loads(data["__args__"].tobytes().decode()))
            flat["__args__"] = np.frombuffer(json.dumps(args).encode(), dtype=np.uint8)
    np.savez(dst, **flat)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--temporal_kernel_size", type=int, default=3)
    args = ap.parse_args(argv)
    inflate(args.input, args.output, args.temporal_kernel_size)
    print(f"inflated {args.input} -> {args.output}")


if __name__ == "__main__":
    main()
