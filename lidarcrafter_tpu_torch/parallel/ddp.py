"""Data parallelism: the port's counterpart of the ``dp`` axis of the JAX
package's ``parallel/mesh.py``.

One process a card (``torchrun --nproc-per-node N``), joined by a
``torch.distributed`` process group (NCCL on the cards, gloo on the CPU).
The global batch stays ``batch_size_train``, as on the JAX ``dp`` mesh:
rank r loads its ``B / N`` rows of each batch of the one seeded stream, and
the engine's loss draws the step's randomness (t, the noise) for the whole
global batch from the step's generator, keeping the rank's rows
(``draws.Rows``), so that every sample sees the draws it would see in one
process.  The gradients are averaged with one
``all_reduce`` of a flat buffer before the optimizer step; every rank
then steps the same optimizer and EMA, and rank 0 alone writes checkpoints
and logs.  With the per-rank losses each a mean over the rank's rows, the
averaged gradient is that of one process on the global batch.

The gradients are reduced here rather than by
``torch.nn.parallel.DistributedDataParallel``: its reducer hooks run in
``.backward()``, and the train step takes its gradients with
``torch.autograd.grad`` (which also yields those of the layout branch's
trained running statistics, buffers that DDP does not reduce).

The group is a (dp, sp) mesh (``mesh.py``): with ``sp`` > 1 the ranks of
one ``dp`` index share its rows of the batch and each holds its columns of
the range images (the JAX mesh's azimuth axis); the gradients are averaged
over the whole world all the same.  With ``sp`` = 1 (the default) it is the
data parallelism above and no subgroup is made.

The multi-host utilities of the JAX package's ``parallel/multihost.py``
live here too: :func:`initialize_distributed` (through
:meth:`DataParallel.join`), :func:`merge_results_dist` (the eval-result
merge, ``all_gather_object``) and :func:`is_main_process`.
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..draws import Rows
from .mesh import batch_sharding, make_mesh


class DataParallel:
    """This process's rank in a ``world``-process group on ``device``, on a
    (world / sp, sp) mesh (:attr:`mesh`)."""

    def __init__(self, rank: int, world: int, device: torch.device, sp: int = 1):
        self.rank, self.world, self.device = rank, world, device
        self.mesh = make_mesh(world=world, sp=sp, rank=rank)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @classmethod
    def from_env(cls, device: str | torch.device = "cuda", sp: int = 1) -> "DataParallel | None":
        """The group ``torchrun`` describes in the environment (``RANK``,
        ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``),
        joined here (NCCL on ``cuda``: the process takes card
        ``LOCAL_RANK``; gloo on the CPU) on a (world / sp, sp) mesh; None
        outside ``torchrun``."""
        if "WORLD_SIZE" not in os.environ:
            return None
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = torch.device(device)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
            torch.cuda.set_device(device)
        return cls.join(rank, world, device, "env://", sp=sp)

    @classmethod
    def join(cls, rank: int, world: int, device: str | torch.device, init_method: str, backend: str | None = None,
             sp: int = 1) -> "DataParallel":
        """Join the group at ``init_method`` (``env://`` or
        ``tcp://host:port``) as ``rank`` of ``world``, over ``backend``
        (NCCL on ``cuda`` and gloo on the CPU by default; gloo for ranks
        that share one card, which NCCL refuses), on a (world / sp, sp)
        mesh."""
        device = torch.device(device)
        if not dist.is_initialized():
            backend = backend or ("nccl" if device.type == "cuda" else "gloo")
            dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
        return cls(rank, world, device, sp)

    def rows(self, local: int, width: int | None = None) -> Rows:
        """This rank's rows of a global batch of ``local · dp`` rows (all of
        them ``local · world`` with ``sp`` = 1), and under ``sp`` > 1 its
        window of the ``width`` columns of the range images."""
        return batch_sharding(self.mesh, 4, sp_axis=2).rows(local * self.mesh.dp, width)

    @torch.no_grad()
    def broadcast_(self, tensors: list[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank."""
        flat = _flatten_dense_tensors([t.detach() for t in tensors])
        dist.broadcast(flat, 0)
        for t, v in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
            t.copy_(v)

    @torch.no_grad()
    def average_(self, tensors: list[torch.Tensor]) -> None:
        """Replace ``tensors`` (same dtype) by their mean over the ranks."""
        flat = _flatten_dense_tensors(tensors)
        dist.all_reduce(flat)
        flat /= self.world
        for t, v in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
            t.copy_(v)

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of a scalar over the ranks."""
        value = value.detach().clone()
        dist.all_reduce(value)
        return value / self.world

    def gather_int(self, value: int) -> list[int]:
        """``value`` of every rank, in rank order."""
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        return [int(v) for v in out]

    @staticmethod
    def leave() -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def initialize_distributed(rank: int | None = None, world: int | None = None, init_method: str | None = None,
                           device: str | torch.device = "cuda") -> DataParallel | None:
    """Join the process group: ``torchrun``'s environment when no ``rank``
    is given (None outside ``torchrun``: one process), else ``rank`` of
    ``world`` at ``init_method`` (``tcp://host:port``)."""
    if rank is None:
        return DataParallel.from_env(device)
    return DataParallel.join(rank, world, device, init_method)


def merge_results_dist(local_results: Any) -> list:
    """Every rank's list of records, concatenated in rank order, on every
    rank; the list itself in one process.  Records are any picklable
    objects (numpy arrays, dicts), and ranks may hold different counts."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return list(local_results)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, list(local_results))
    return [r for part in parts for r in part]


def is_main_process() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
