"""The ("data", "frames") mesh, counterpart of ``videoseal_tpu/parallel/mesh.py``
on ``torch.distributed.device_mesh``.

The JAX package shards a batch on the ``data`` axis of a device mesh (a
video batch's frames, optionally, on ``frames``) and lets XLA insert the
collectives; the port runs one process per rank, each on its contiguous
block of the global batch, and reduces explicitly (``parallel/trainer.py``,
``modules/common.BatchNorm2d``, ``augmentation/augmenter.py``). Rank r sits
at (r // n_frames, r % n_frames): the ranks of one clip are neighbours.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils.dist import gather_rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh: each axis's group (None for one
    process without a process group), its rank and its size, and the group
    of every rank (`all_group`)."""
    group: object = None         # the data axis
    rank: int = 0
    size: int = 1
    device_mesh: object = None
    frames_group: object = None
    frames_rank: int = 0
    frames_size: int = 1
    all_group: object = None

    @property
    def world(self) -> int:
        return self.size * self.frames_size

    def shard(self, n: int) -> slice:
        """This rank's rows of a global batch of `n` on the data axis
        (contiguous, equal)."""
        return _block(n, self.rank, self.size)

    def frames_shard(self, n: int) -> slice:
        """This rank's frames of a clip of `n` on the frames axis."""
        return _block(n, self.frames_rank, self.frames_size)

    def rows(self, clips: int, frames: int = 1) -> torch.Tensor:
        """The global indices of this rank's rows of a batch flattened from
        (clips, frames), the rank holding `clips` clips of `frames` frames:
        the global batch is (clips * size, frames * frames_size) in that
        order. On the CPU; a frames axis needs `frames` > 1 or a rank would
        hold a copy of its frames neighbours' rows."""
        f_all = frames * self.frames_size
        clip = torch.arange(self.rank * clips, (self.rank + 1) * clips)
        frame = torch.arange(self.frames_rank * frames, (self.frames_rank + 1) * frames)
        return (clip[:, None] * f_all + frame[None]).reshape(-1)


def _block(n: int, rank: int, size: int) -> slice:
    if n % size:
        raise ValueError(f"a global batch of {n} does not split over {size} ranks")
    k = n // size
    return slice(rank * k, (rank + 1) * k)


def make_mesh(n_data: int | None = None, n_frames: int = 1,
              device_type: str | None = None) -> Mesh:
    """A mesh over ("data", "frames") of n_data x n_frames ranks (n_data
    defaults to the world size over n_frames); without a process group,
    the one-process mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_data not in (None, 1) or n_frames != 1:
            raise ValueError(f"a {n_data}x{n_frames} mesh without a process group")
        return Mesh()
    world = dist.get_world_size()
    n_data = world // n_frames if n_data is None else n_data
    if n_data * n_frames != world:
        raise ValueError(f"a {n_data}x{n_frames} mesh over {world} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    dm = init_device_mesh(device_type, (n_data, n_frames), mesh_dim_names=("data", "frames"))
    rank = dist.get_rank()
    return Mesh(group=dm.get_group("data"), rank=rank // n_frames, size=n_data, device_mesh=dm,
                frames_group=dm.get_group("frames"), frames_rank=rank % n_frames,
                frames_size=n_frames, all_group=dist.group.WORLD)


def shard_batch(mesh: Mesh, batch, frames_axis: int | None = None):
    """This rank's block of each array of a global batch (a dict, or one
    array): axis 0 by data rank and, with `frames_axis`, that axis by
    frames rank, as the JAX package's `batch_sharding` lays it out."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, frames_axis) for k, v in batch.items()}
    batch = batch[mesh.shard(batch.shape[0])]
    if frames_axis is None or mesh.frames_size == 1:
        return batch
    idx = (slice(None),) * frames_axis + (mesh.frames_shard(batch.shape[frames_axis]),)
    return batch[idx]


def gather_frames(x: torch.Tensor, mesh: Mesh, start: int | None = None,
                  total: int | None = None) -> torch.Tensor:
    """A clip (V, F, ...) from its frames ranks' blocks (V, F_r, ...) on
    axis 1, differentiably: this rank's block starts at frame `start` of
    `total` (by default the equal blocks of ``shard_batch``; the ranks'
    blocks may differ in length, as the key frames of a clip do)."""
    if mesh.frames_group is None or mesh.frames_size == 1:
        return x
    n = x.shape[1]
    start = mesh.frames_rank * n if start is None else start
    total = n * mesh.frames_size if total is None else total
    moved = x.transpose(0, 1)
    full = gather_rows(moved, torch.arange(start, start + n), total, mesh.frames_group)
    return full.transpose(0, 1)


def use_global_batchnorm(module: torch.nn.Module, mesh: Mesh) -> None:
    """Point every BatchNorm of `module` at the group of every rank: in
    train mode each then normalises with the global batch's statistics."""
    from ..modules.common import BatchNorm2d
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = mesh.all_group
