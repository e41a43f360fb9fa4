"""Run a function on several local processes joined in one process group,
without torchrun: the CPU tests' two gloo ranks, and two ranks sharing one
card over gloo in ``chip_smoke.py``.

    results = run_local(fn, 2, *args)           # fn(rank, *args) on each rank

`fn` must be importable (the ranks are spawned, not forked). Each rank
joins ``tcp://127.0.0.1:<free port>`` with the given backend; each result
comes back through ``torch.save`` in a temporary directory.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, backend, out_dir, args):
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, *args), os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_local(fn, world: int, *args, backend: str = "gloo", timeout: float = 900.0) -> list:
    """[fn(rank, *args) for each rank], run on `world` spawned processes in
    one process group; raises if a rank fails or the time runs out (the
    ranks are then terminated)."""
    with tempfile.TemporaryDirectory(prefix="vs_ranks_") as out_dir:
        ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), backend, out_dir,
                                                   args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]
