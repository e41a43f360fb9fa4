"""Process-group set-up and helpers, counterpart of
``videoseal_tpu/utils/dist.py`` on ``torch.distributed``.

`init_distributed_mode` reads the environment the reference's launchers
set: SLURM (``SLURM_NTASKS`` > 1; the first host of the node list is the
rendezvous, as the JAX package parses it) or a torchrun-style launch
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
The backend is NCCL on the card and gloo on the CPU; each rank takes
``cuda:LOCAL_RANK``. A single process without either environment stays a
no-op, as the JAX package's does.

`all_reduce_sum` is differentiable: the data-parallel step reduces
BatchNorm's statistics, the balance's gradient norms and attack inputs
through it, and its backward reduces the cotangents the same way.
"""

from __future__ import annotations

import os
import re
import subprocess

import torch
import torch.distributed as dist


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def _slurm_first_host(nodelist: str) -> str:
    """First hostname of a SLURM node list (scontrol where it exists, else
    a parse of the 'prefix[1-4,7]' syntax)."""
    try:
        out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.split()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    m = re.match(r"([^\[,]+)(?:\[(\d+)[-,\d]*\])?", nodelist)
    if not m:
        return nodelist
    prefix, first = m.group(1), m.group(2)
    return f"{prefix}{first}" if first else prefix


def init_distributed_mode(device: str = "cuda", port: int = 29500) -> torch.device:
    """Join the process group the environment describes and return this
    rank's device: ``cuda:LOCAL_RANK`` (NCCL) or the CPU (gloo) when
    `device` is "cpu". A group the caller already made is kept. Without
    either: no group, `device` (``cuda`` is ``cuda:0``)."""
    env = os.environ
    if is_dist_avail_and_initialized():      # a group the caller made
        if device == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
    if "SLURM_JOB_ID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", "0"))
        addr = f"tcp://{_slurm_first_host(env['SLURM_JOB_NODELIST'])}:{port}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", "0"))
        addr = "env://"
    else:
        return torch.device("cpu") if device == "cpu" else torch.device("cuda", 0)
    if device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        dev, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=addr, rank=rank, world_size=world)
    return dev


def comm_device(group=None) -> torch.device:
    """Where a host-side value goes for a collective on `group`: the
    current card for NCCL, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the group's ranks, on every rank. Its gradient
    is the sum of the ranks' cotangents: with every rank's loss summed into
    one objective, each rank receives the derivative of that objective."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, rows: torch.Tensor, total: int, group=None) -> torch.Tensor:
    """A (total, ...) tensor whose rows the group's ranks hold between them,
    on every rank, differentiably: each rank writes its rows `x` at the
    global indices `rows` into zeros and the group sums them (gloo reduces
    CUDA tensors; it has no all-gather into one tensor). The gradient of
    `x` is the sum of the ranks' cotangents of its rows."""
    full = x.new_zeros((total,) + tuple(x.shape[1:]))
    return all_reduce_sum(full.index_add(0, rows.to(x.device), x), group)


def average_metrics(metrics: dict, group=None) -> dict:
    """Each metric's mean over the group's ranks (every rank calls it at
    the same point); a single process returns `metrics` as floats."""
    if not is_dist_avail_and_initialized():
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                        device=comm_device(group))
    dist.all_reduce(vals, op=dist.ReduceOp.SUM, group=group)
    vals /= dist.get_world_size(group)
    return {k: float(v) for k, v in zip(keys, vals.tolist())}
