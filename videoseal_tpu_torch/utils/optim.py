"""Optimizer and schedule construction, counterpart of
``videoseal_tpu/utils/optim.py``, on ``torch.optim``.

The same mini-DSLs as the reference:
  build_optimizer("AdamW,lr=1e-4", params)
  build_lr_schedule("CosineLRScheduler,lr_min=1e-6,t_initial=301,
                     warmup_lr_init=1e-8,warmup_t=5", steps_per_epoch, base_lr)
  ScalingSchedule("Linear,scaling_min=0.2,epochs=500", initial)
The schedules are per-step functions with optax's curves (the lr of the
update that step `count` makes); ``lr_scheduler`` runs one under a
``LambdaLR``, so the first update uses schedule(0), as optax's does.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch


def parse_params(s: str) -> dict[str, Any]:
    """'AdamW,lr=1e-4' -> {'name': 'AdamW', 'lr': 1e-4}."""
    s = s.replace(" ", "")
    name, *rest = s.split(",")
    out: dict[str, Any] = {"name": name}
    for kv in rest:
        if not kv:
            continue
        k, v = kv.split("=")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def build_optimizer(spec: str | dict, params) -> torch.optim.Optimizer:
    """The reference's optimizer names on torch.optim, with optax's
    defaults: AdamW's weight decay 1e-2, betas (0.9, 0.999), eps 1e-8;
    lamb and adafactor as optax builds them (`Lamb`, `Adafactor`)."""
    p = parse_params(spec) if isinstance(spec, str) else dict(spec)
    name = p.pop("name").lower()
    lr = float(p.pop("lr", 1e-3))
    wd = p.pop("weight_decay", None)
    betas = (p.pop("beta1", 0.9), p.pop("beta2", 0.999))
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=wd if wd is not None else 1e-2)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=p.pop("momentum", 0.0))
    if name == "lamb":
        return Lamb(params, lr=lr)
    if name == "adafactor":
        return Adafactor(params, lr=lr)
    raise NotImplementedError(f"optimizer {name}")


class Lamb(torch.optim.Optimizer):
    """``optax.lamb`` with its defaults: Adam's bias-corrected moments (eps
    outside the root), plus weight_decay * p, scaled per tensor by the trust
    ratio ||p|| / ||update|| (1 where either norm is 0), times -lr. State per
    parameter: step, exp_avg, exp_avg_sq."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = float(st["step"])
                g = p.grad
                st["exp_avg"].lerp_(g, 1 - b1)
                st["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = ((st["exp_avg"] / (1 - b1 ** t))
                     / ((st["exp_avg_sq"] / (1 - b2 ** t)).sqrt() + group["eps"]))
                if group["weight_decay"]:
                    u.add_(p, alpha=group["weight_decay"])
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                trust = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                p.sub_(u * (trust * group["lr"]))


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's rule: (d1, d0), the two largest axes, when a tensor of two or
    more axes has its second largest of at least min_dim_size_to_factor;
    else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` with its defaults (not ``torch.optim.Adafactor``'s
    rule): the second moment factored over the two largest axes (optax's
    `factored_dims`) or kept whole, decay 1 - (t+1)^-0.8, eps 1e-30 on the
    squared gradient, the update clipped to an RMS of 1 per tensor, times
    lr, times max(RMS(p), 1e-3), subtracted. State per parameter: step and
    either v_row and v_col (the moment's means over axes d0 and d1, those
    axes kept with size 1) or v."""

    def __init__(self, params, lr: float = 1e-3, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, eps: float = 1e-30,
                 clipping_threshold: float = 1.0, min_scale: float = 1e-3):
        super().__init__(params, dict(lr=lr, decay_rate=decay_rate,
                                      min_dim_size_to_factor=min_dim_size_to_factor, eps=eps,
                                      clipping_threshold=clipping_threshold,
                                      min_scale=min_scale))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                dims = factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    if dims is None:
                        st["v"] = torch.zeros_like(p)
                    else:
                        st["v_row"] = torch.zeros_like(p.sum(dims[1], keepdim=True))
                        st["v_col"] = torch.zeros_like(p.sum(dims[0], keepdim=True))
                decay = 1.0 - (float(st["step"]) + 1.0) ** -group["decay_rate"]
                st["step"] += 1
                g = p.grad
                g2 = g * g + group["eps"]
                if dims is None:
                    st["v"].mul_(decay).add_(g2, alpha=1 - decay)
                    u = g * st["v"].rsqrt()
                else:
                    d1, d0 = dims
                    st["v_row"].mul_(decay).add_(g2.mean(d0, keepdim=True), alpha=1 - decay)
                    st["v_col"].mul_(decay).add_(g2.mean(d1, keepdim=True), alpha=1 - decay)
                    row = (st["v_row"] / st["v_row"].mean(d1, keepdim=True)).rsqrt()
                    u = g * row * st["v_col"].rsqrt()
                rms = u.square().mean().sqrt()
                u = u / torch.clamp(rms / group["clipping_threshold"], min=1.0)
                u = u * group["lr"]
                p.sub_(u * torch.clamp(p.square().mean().sqrt(), min=group["min_scale"]))


def build_lr_schedule(spec: str | None, steps_per_epoch: int = 1,
                      base_lr: float = 1e-3) -> Callable[[int], float] | float:
    """A timm-style spec -> the lr as a function of the step (optax's
    warmup_cosine_decay_schedule and exponential_decay curves); no spec ->
    base_lr."""
    if not spec or spec in ("None", "none"):
        return base_lr
    p = parse_params(spec)
    name = p.pop("name").lower()
    if "cosine" in name:
        total = max(int(p.get("t_initial", 100)) * steps_per_epoch, 2)
        warmup = max(int(p.get("warmup_t", 0)) * steps_per_epoch, 1)
        lr_min = float(p.get("lr_min", 0.0))
        init = float(p.get("warmup_lr_init", 0.0))
        alpha = 0.0 if base_lr == 0.0 else lr_min / base_lr
        if total - warmup <= 0:
            raise ValueError(f"cosine schedule: {total} steps leave none after a "
                             f"{warmup}-step warmup")

        def cosine(count: int) -> float:
            if count < warmup:
                return init + (base_lr - init) * count / warmup
            t = min(count - warmup, total - warmup)
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / (total - warmup)))
                              + alpha)

        return cosine
    if "step" in name:
        decay_t = int(p.get("decay_t", 30)) * steps_per_epoch
        rate = float(p.get("decay_rate", 0.1))
        return lambda count: base_lr * rate ** (count // decay_t)
    raise NotImplementedError(f"scheduler {name}")


def lr_scheduler(optimizer: torch.optim.Optimizer, schedule) -> torch.optim.lr_scheduler.LambdaLR:
    """`schedule` (a per-step function of `build_lr_schedule`) driving
    `optimizer`'s lr: step() after each update."""
    base = optimizer.param_groups[0]["lr"]
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda count: schedule(count) / base)


class ScalingSchedule:
    """A schedule on a pipeline attribute by epoch: the blender's
    scaling_w."""

    def __init__(self, spec: str | dict, initial_value: float):
        p = parse_params(spec) if isinstance(spec, str) else dict(spec)
        self.kind = p.get("name", "Linear").lower()
        self.initial = initial_value
        self.final = float(p.get("scaling_min", initial_value))
        self.start = int(p.get("start_epoch", 0))
        self.epochs = int(p.get("epochs", 1))

    def __call__(self, epoch: int) -> float:
        t = min(max(epoch - self.start, 0) / max(self.epochs, 1), 1.0)
        if t <= 0:
            return self.initial
        if self.kind.startswith("lin"):
            return self.initial + t * (self.final - self.initial)
        if self.kind.startswith("cos"):
            return self.final + 0.5 * (self.initial - self.final) * (1 + math.cos(math.pi * t))
        raise NotImplementedError(self.kind)
