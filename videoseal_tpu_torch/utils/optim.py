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
    defaults: AdamW's weight decay 1e-2, betas (0.9, 0.999), eps 1e-8."""
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
    if name in ("lamb", "adafactor"):
        raise NotImplementedError(f"optimizer {name}: ROADMAP.md 1.8")
    raise NotImplementedError(f"optimizer {name}")


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
