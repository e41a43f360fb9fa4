"""K8: what inside the ConvNeXt block kernel costs the most on the card?
(perf tool, not a serving path)

Counterpart of ``videoseal_tpu/kernels/convnext_probe.py``. Its variants
run K2's four parts (``csrc/convnext_dwln.cuh``, ``csrc/convnext_pw.cuh``;
entry in ``csrc/convnext_probe.cu``) with their switches set: the depthwise
form (dw_plain's "taps", "shift", "perdy", "bf16"), the activation after pw1
(ACTIVATIONS' "none", "erf", "sigmoid", "tanh") and a depthwise-only flag;
the full-block variants run dwln, pw1, grn_stats and pw2 on K2's tile
shapes. The TPU's variant names are kept. "block_gelu" here is the erf
GELU, the model's (the TPU probe's block_gelu called the tanh form), and
"production_block" is K2's own block on the probe's input: on a zero halo,
K2 bit for bit.

The input is a bf16 (B, H+6, W+6, C) tensor whose 3-pixel halo is random
data, as on the TPU; the depthwise-only variants return the bf16 sum without
its bias.

Run on the card: python -m videoseal_tpu_torch.kernels.convnext_probe [--dw]
"""

from __future__ import annotations

import json
import sys

import torch

from . import _lib
from .convnext_block import _PARAM_ORDER, _check, _check_shape, block_plain_padded, dw_plain

# variant -> (depthwise form, activation, depthwise only); the order is the
# variant index of csrc vs_cnx_probe
VARIANTS = {
    "dwconv_taps": ("taps", "none", True),
    "dwconv_shift": ("shift", "none", True),
    "dwconv_perdy": ("perdy", "none", True),
    "dwconv_bf16": ("bf16", "none", True),
    "block_nogelu": ("shift", "none", False),
    "block_gelu": ("shift", "erf", False),
    "block_gelu_sigmoid": ("shift", "sigmoid", False),
    "block_gelu_tanh": ("shift", "tanh", False),
    "block_gelu_tanh_bf16dw": ("bf16", "tanh", False),
    "production_block": ("perdy", "erf", False),
}


def _variant(variant: str) -> tuple[str, str, bool]:
    if variant not in VARIANTS:
        raise ValueError(f"convnext_probe: unknown variant {variant!r}")
    return VARIANTS[variant]


def convnext_probe_plain(xpad: torch.Tensor, p: dict, variant: str) -> torch.Tensor:
    """Plain PyTorch version of K8. xpad (B, H+6, W+6, C) bf16, p from
    `block_params` -> (B, H, W, C) bf16."""
    form, act, dw_only = _variant(variant)
    if dw_only:
        return dw_plain(xpad, p["dw"], form).to(torch.bfloat16)
    return block_plain_padded(xpad, p, torch.bfloat16, form, act)


def _launch(xpad: torch.Tensor, p: dict, variant: str) -> torch.Tensor:
    _, _, dw_only = _variant(variant)
    _check("convnext_probe", xpad, [p], (torch.bfloat16,))
    if "c" in p:
        raise ValueError("convnext_probe kernel takes widths that are multiples of 16 "
                         "(no padded parameters)")
    b, hp, wp, c = xpad.shape
    h, w = hp - 6, wp - 6
    bm = _check_shape(b, h, w, c)
    if xpad.data_ptr() % 16:
        raise ValueError("convnext_probe kernel takes xpad at a 16-byte aligned address")
    dev, hw = xpad.device, h * w
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=dev)
    bufs = [None] * 4   # a, hid, part, gn: K2's buffers, unused by the depthwise-only
    if not dw_only:
        bufs = [torch.empty((b * hw, c), dtype=torch.bfloat16, device=dev),
                torch.empty((b * hw, 4 * c), dtype=torch.bfloat16, device=dev),
                torch.empty((b, -(-hw // bm), 4 * c), dtype=torch.float32, device=dev),
                torch.empty((b, 4 * c), dtype=torch.float32, device=dev)]
    _lib.check(_lib.library().vs_cnx_probe(
        xpad.data_ptr(), *[p[n].data_ptr() for n in _PARAM_ORDER],
        *[None if t is None else t.data_ptr() for t in bufs], out.data_ptr(), b, h, w, c, bm,
        list(VARIANTS).index(variant), _lib.stream_ptr(xpad)), "vs_cnx_probe")
    return out


def convnext_probe(xpad: torch.Tensor, p: dict, variant: str) -> torch.Tensor:
    """K8: the plain version for a CPU tensor, the Hopper kernel for a CUDA
    tensor (which raises on what it does not take)."""
    if xpad.device.type == "cpu":
        return convnext_probe_plain(xpad, p, variant)
    if xpad.device.type != "cuda":
        raise ValueError(f"convnext_probe: unsupported device {xpad.device}")
    out = _launch(xpad, p, variant)
    convnext_probe.launches += 1
    return out


convnext_probe.launches = 0


def probe_inputs(b: int, h: int, w: int, c: int, device, seed: int = 0) -> tuple:
    """The TPU probe's inputs: x ~ N(0, 1) bf16 with a random halo, dw ~
    N(0, 0.1), the pointwise weights ~ N(0, 0.05) in bf16, and one N(0, 1)
    vector of each width for every bias and norm parameter."""
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *shape, std=1.0: torch.randn(shape, generator=g, device=device) * std
    xpad = rn(b, h + 6, w + 6, c).to(torch.bfloat16)
    vc, v4 = rn(c), rn(4 * c)
    p = {"dw": rn(49, c, std=0.1), "dwb": vc, "lnw": vc, "lnb": vc,
         "w1": rn(4 * c, c, std=0.05).to(torch.bfloat16), "b1": v4, "gamma": v4, "beta": v4,
         "w2": rn(c, 4 * c, std=0.05).to(torch.bfloat16), "b2": vc}
    return xpad, p


def run(variant: str, b: int = 128, h: int = 64, w: int = 64, c: int = 96,
        reps: int = 3) -> dict:
    """Time one variant on the card and print its JSON line."""
    from ..utils.timing import cuda_ms
    xpad, p = probe_inputs(b, h, w, c, torch.device("cuda"))
    ms = cuda_ms(lambda: convnext_probe(xpad, p, variant), reps)
    rec = {"variant": variant, "shape": [b, h, w, c], "ms": ms, "us_per_frame": ms * 1e3 / b}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list[dict]:
    """The TPU probe's sweep: with --dw the depthwise forms and the tanh
    blocks at the stage-0 and stage-1 shapes, else the activations' blocks
    and the production block at stage 0."""
    argv = sys.argv[1:] if argv is None else argv
    if "--dw" in argv:
        recs = [run(v) for v in ("dwconv_taps", "dwconv_shift", "dwconv_perdy", "dwconv_bf16",
                                 "block_gelu_tanh", "block_gelu_tanh_bf16dw")]
        return recs + [run(v, b=128, h=32, w=32, c=192)
                       for v in ("dwconv_perdy", "dwconv_bf16", "block_gelu_tanh",
                                 "block_gelu_tanh_bf16dw")]
    return [run(v) for v in ("block_nogelu", "block_gelu", "block_gelu_sigmoid",
                             "block_gelu_tanh", "production_block")]


if __name__ == "__main__":
    main()
