"""Convert the perceptual losses' torch weights to the ``.npz`` files both
packages read (``losses/lpips.py``), counterpart of
``videoseal_tpu/tools/convert_lpips.py``; the files are the same.

Sources, all local files:
* a torchvision VGG16 (or AlexNet) state dict (``features.{i}.*``): the
  backbone of LPIPS and DISTS;
* an ``lpips`` package checkpoint: the trained ``lin{i}.model.1.weight``
  heads;
* the Watson-VGG checkpoint (``rgb_watson_vgg_trial0.pth``): its own
  ``vgg.slice*`` weights and the t/w/beta sensitivities;
* the DISTS checkpoint (``dists_ckpt.pth``): alpha and beta (the backbone
  from torchvision's VGG16, or its own ``stage*`` weights).

  python -m videoseal_tpu_torch.tools.convert_lpips --out weights_dir \\
      [--vgg16 vgg16.pth --lpips lpips_vgg.pth] [--alexnet alexnet.pth \\
      --lpips_alex lpips_alex.pth] [--watson rgb_watson_vgg_trial0.pth] \\
      [--dists dists_ckpt.pth]

writes lpips_vgg.npz, lpips_alex.npz, watson_vgg.npz and dists.npz.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.checkpoint import flatten_tree

# torchvision VGG16 features index -> (stage, conv within the stage)
_CONV_IDX = {0: (0, 0), 2: (0, 1), 5: (1, 0), 7: (1, 1),
             10: (2, 0), 12: (2, 1), 14: (2, 2),
             17: (3, 0), 19: (3, 1), 21: (3, 2),
             24: (4, 0), 26: (4, 1), 28: (4, 2)}
# the Watson-VGG slices own these feature indices
_SLICE_OF_IDX = {i: s for s, rng in enumerate(
    [range(0, 4), range(4, 9), range(9, 16), range(16, 23), range(23, 30)], start=1)
    for i in rng}


def _hwio(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def convert_vgg_features(sd, key_of) -> dict:
    """VGG16 features' parameters from a state dict whose key for feature
    index `idx` and leaf 'weight' or 'bias' is key_of(idx, leaf)."""
    return {f"conv{si}_{ci}": {"kernel": _hwio(sd[key_of(idx, "weight")]),
                               "bias": np.asarray(sd[key_of(idx, "bias")])}
            for idx, (si, ci) in _CONV_IDX.items()}


def _tv_key(idx, leaf):
    return f"features.{idx}.{leaf}"


def _watson_key(idx, leaf):
    return f"vgg.slice{_SLICE_OF_IDX[idx]}.{idx}.{leaf}"


def _dists_key(idx, leaf):
    stage = _SLICE_OF_IDX[idx] if idx != 23 else 5    # stage5 starts at 23 (the pool)
    return f"stage{stage}.{idx}.{leaf}"


def _lin_heads(lpips_sd, params):
    for i in range(5):
        key = next((k for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight")
                    if k in lpips_sd), None)
        if key is None:
            raise KeyError(f"lpips checkpoint missing lin{i} head")
        params[f"lin{i}"] = np.asarray(lpips_sd[key]).reshape(-1)   # (1, C, 1, 1) -> (C,)
    return params


def convert_lpips(vgg16_sd, lpips_sd) -> dict:
    """torchvision VGG16 + the lpips heads -> LPIPS(net='vgg') parameters."""
    return _lin_heads(lpips_sd, {"vgg": convert_vgg_features(vgg16_sd, _tv_key)})


def convert_lpips_alex(alexnet_sd, lpips_sd) -> dict:
    """torchvision AlexNet + the lpips heads -> LPIPS(net='alex') parameters
    (the reference's eval-time LPIPS)."""
    alex = {f"conv{ci}": {"kernel": _hwio(alexnet_sd[f"features.{idx}.weight"]),
                          "bias": np.asarray(alexnet_sd[f"features.{idx}.bias"])}
            for ci, idx in enumerate((0, 3, 6, 8, 10))}
    return _lin_heads(lpips_sd, {"alex": alex})


def convert_watson_vgg(watson_sd) -> dict:
    """The Watson-VGG checkpoint (its VGG slices and sensitivities)."""
    params = {"vgg": convert_vgg_features(watson_sd, _watson_key),
              "beta": np.asarray(watson_sd["beta"])}
    for i in range(5):
        params[f"t{i}_tild"] = np.asarray(watson_sd[f"t{i}_tild"])
        params[f"w{i}_tild"] = np.asarray(watson_sd[f"w{i}_tild"])
    return params


def convert_dists(vgg16_sd, dists_sd) -> dict:
    """torchvision VGG16 (or the DISTS checkpoint's own stage*.* weights)
    + alpha and beta."""
    if "stage1.0.weight" in dists_sd:
        vgg = convert_vgg_features(dists_sd, _dists_key)
    else:
        if vgg16_sd is None:
            raise ValueError("--dists without stage weights needs --vgg16")
        vgg = convert_vgg_features(vgg16_sd, _tv_key)
    return {"vgg": vgg, "alpha": np.asarray(dists_sd["alpha"]).reshape(-1),
            "beta": np.asarray(dists_sd["beta"]).reshape(-1)}


def load_state_dict(path: str) -> dict:
    """A .pth file's state dict (under ``state_dict`` where it is nested)
    as numpy arrays; tensors only are unpickled."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="output weights directory")
    ap.add_argument("--vgg16", help="torchvision vgg16 state dict (.pth)")
    ap.add_argument("--alexnet", help="torchvision alexnet state dict (.pth)")
    ap.add_argument("--lpips", help="lpips package vgg checkpoint (.pth)")
    ap.add_argument("--lpips_alex", help="lpips package alex checkpoint (.pth)")
    ap.add_argument("--watson", help="rgb_watson_vgg_trial0.pth")
    ap.add_argument("--dists", help="dists_ckpt.pth (alpha/beta weights)")
    args = ap.parse_args(argv)
    if args.lpips and not args.vgg16:
        ap.error("--lpips needs --vgg16")
    if args.lpips_alex and not args.alexnet:
        ap.error("--lpips_alex needs --alexnet")
    os.makedirs(args.out, exist_ok=True)
    vgg16_sd = load_state_dict(args.vgg16) if args.vgg16 else None
    jobs = []
    if args.lpips:
        jobs.append(("lpips_vgg.npz", lambda: convert_lpips(vgg16_sd, load_state_dict(args.lpips))))
    if args.lpips_alex:
        jobs.append(("lpips_alex.npz", lambda: convert_lpips_alex(
            load_state_dict(args.alexnet), load_state_dict(args.lpips_alex))))
    if args.watson:
        jobs.append(("watson_vgg.npz", lambda: convert_watson_vgg(load_state_dict(args.watson))))
    if args.dists:
        jobs.append(("dists.npz", lambda: convert_dists(vgg16_sd, load_state_dict(args.dists))))
    for name, convert in jobs:
        np.savez(os.path.join(args.out, name), **flatten_tree(convert()))
        print(f"wrote {name}")


if __name__ == "__main__":
    main()
