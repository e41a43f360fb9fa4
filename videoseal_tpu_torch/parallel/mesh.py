"""The data-parallel mesh, counterpart of ``videoseal_tpu/parallel/mesh.py``
on ``torch.distributed.device_mesh``.

The JAX package shards the batch on a ``data`` axis of a device mesh and
lets XLA insert the collectives; the port runs one process per rank, each
on its contiguous slice of the global batch, and reduces explicitly
(``parallel/trainer.py``, ``modules/common.BatchNorm2d``, ``utils/dist``).
Only the ``data`` axis is carried: a ``frames`` axis needs collectives in
the video-mode expand and the per-clip message aggregate (ROADMAP.md 1.8).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils.dist import all_reduce_sum


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the data axis: its group (None for one
    process without a process group), rank and the axis's size."""
    group: object = None
    rank: int = 0
    size: int = 1
    device_mesh: object = None

    def shard(self, n: int) -> slice:
        """This rank's rows of a global batch of `n` (contiguous, equal)."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} does not split over {self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def make_mesh(n_data: int | None = None, n_frames: int = 1,
              device_type: str | None = None) -> Mesh:
    """A mesh over ("data", "frames") with every rank on the data axis;
    without a process group, the one-process mesh."""
    if n_frames != 1:
        raise NotImplementedError("a frames axis (n_frames > 1): ROADMAP.md 1.8")
    if not (dist.is_available() and dist.is_initialized()):
        if n_data not in (None, 1):
            raise ValueError(f"n_data={n_data} without a process group")
        return Mesh()
    world = dist.get_world_size()
    if n_data not in (None, world):
        raise ValueError(f"n_data={n_data}: every one of the {world} ranks is on the data axis")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    dm = init_device_mesh(device_type, (world, 1), mesh_dim_names=("data", "frames"))
    return Mesh(group=dm.get_group("data"), rank=dist.get_rank(), size=world, device_mesh=dm)


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of each array of a global batch (a dict, or one
    array), on axis 0."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    return batch[mesh.shard(batch.shape[0])]


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every rank's slice of it, differentiably: each
    rank writes its rows into zeros and the group sums them (gloo reduces
    CUDA tensors; it has no all-gather into one tensor). The gradient of
    the local rows is the sum of the ranks' cotangents of those rows."""
    if mesh.group is None:
        return x
    full = x.new_zeros((x.shape[0] * mesh.size,) + tuple(x.shape[1:]))
    idx = torch.arange(mesh.rank * x.shape[0], (mesh.rank + 1) * x.shape[0], device=x.device)
    return all_reduce_sum(full.index_add(0, idx, x), mesh.group)


def use_data_group(module: torch.nn.Module, mesh: Mesh) -> None:
    """Point every BatchNorm of `module` at the mesh's data group: in train
    mode each then normalises with the global batch's statistics."""
    from ..modules.common import BatchNorm2d
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = mesh.group
