"""Threaded prefetching batch loader over a map-style dataset.

Port of the JAX package's ``native/loader.py::PrefetchLoader``: infinite
shuffled epochs (one permutation an epoch from
``np.random.RandomState(seed)``), ``drop_last`` batching, one ``collate``
call a batch, and up to ``queue_depth`` batches in flight on a thread pool.
Threads, not processes: a sample is file reads, numpy and the projection on
CPU tensors, which release the GIL.  Each worker thread runs torch on one
intra-op thread, so that the pool does not oversubscribe the host that
feeds the card.

Every sample is loaded with ``dataset.sample(index, seed)`` where the
dataset has it, ``seed`` being ``sample_seed(seed, epoch, index)``, so its
random draws do not depend on which thread loads it or when: 0 and N
workers give the same batches, on the random train split too.  Under data
parallelism (``world`` > 1) rank ``rank`` loads its rows of each batch of
the one seeded stream, so the samples seen do not depend on the world size.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from .nuscenes import sample_seed


def _one_torch_thread() -> None:
    torch.set_num_threads(1)


class PrefetchLoader:
    """Iterate collated batches of ``batch_size`` samples (this rank's
    ``batch_size // world`` of them); ``num_workers`` 0 loads them on the
    calling thread, as they are asked for."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate: Callable | None = None,
        num_workers: int = 2,
        queue_depth: int = 4,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
    ):
        if len(dataset) < batch_size:
            raise ValueError(f"dataset ({len(dataset)}) smaller than one batch ({batch_size}): "
                             "drop_last would yield nothing")
        if batch_size % world:
            raise ValueError(f"batch {batch_size} does not split over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate if collate is not None else dataset.collate_fn
        self.num_workers = max(0, int(num_workers))
        self.queue_depth = max(1, int(queue_depth))
        self.seed = seed
        self.rows = slice(rank * batch_size // world, (rank + 1) * batch_size // world)

    def _index_stream(self) -> Iterator[list[tuple[int, int]]]:
        """(index, sample seed) of this rank's rows of each batch."""
        rng = np.random.RandomState(self.seed)
        B = self.batch_size
        epoch = 0
        while True:
            order = rng.permutation(len(self.dataset))
            for i in range(0, len(order) - B + 1, B):
                yield [(int(j), sample_seed(self.seed, epoch, int(j))) for j in order[i: i + B][self.rows]]
            epoch += 1

    def load(self, index: int, seed: int):
        if hasattr(self.dataset, "sample"):
            return self.dataset.sample(index, seed)
        return self.dataset[index]

    def __iter__(self):
        stream = self._index_stream()
        if self.num_workers == 0:
            while True:
                yield self.collate([self.load(j, s) for j, s in next(stream)])
        pool = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="lct-loader",
                                  initializer=_one_torch_thread)
        try:
            pending: deque = deque()
            for _ in range(self.queue_depth):
                pending.append([pool.submit(self.load, j, s) for j, s in next(stream)])
            while True:
                futs = pending.popleft()
                batch = self.collate([f.result() for f in futs])
                pending.append([pool.submit(self.load, j, s) for j, s in next(stream)])
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
