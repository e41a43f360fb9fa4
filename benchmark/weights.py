"""Random weights for a card, drawn from the seed on the device.

One normal draw in the served dtype covers every floating tensor of the
state dict; each tensor's slice is then scaled by its kind:

* conv and dense weights: N(0, 1 / fan_in), fan_in the product of all but
  the output axis (a depthwise 7x7 conv: 49);
* the message table: N(0, 1);
* norm scales: 1 + 0.1 N; biases, GRN's gamma and beta: 0.1 N;
* BatchNorm statistics: running mean 0.1 N, running variance exp(0.3 N),
  so that every BatchNorm does work and activations stay O(1) with depth.

The names and shapes come from `shapes` (reference names, as the port's
state dict has them); the values never come from the port.
"""

from __future__ import annotations

import torch


def _kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return "count"
    if "msg_embeddings" in name:
        return "table"
    if leaf in ("running_mean", "bias", "gamma", "beta"):
        return "small"
    if leaf == "running_var":
        return "var"
    if leaf == "weight" and len(shape) >= 2:
        return "fan_in"
    if leaf == "weight":
        return "scale"
    raise ValueError(f"no rule draws {name} {shape}")


def draw(shapes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: shape} -> {name: tensor} on `device`, the same for the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kinds = {k: _kind(k, tuple(s)) for k, s in shapes.items()}
    sizes = {k: int(torch.Size(s).numel()) for k, s in shapes.items() if kinds[k] != "count"}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind = kinds[name]
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        t = flat[at:at + sizes[name]].view(shape)
        at += sizes[name]
        if kind == "fan_in":
            t.mul_(torch.Size(shape[1:]).numel() ** -0.5)
        elif kind == "small":
            t.mul_(0.1)
        elif kind == "scale":
            t.mul_(0.1).add_(1.0)
        elif kind == "var":
            t.mul_(0.3).exp_()
        out[name] = t
    return out
