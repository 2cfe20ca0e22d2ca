"""A data-parallel rank's share of a training step's random draws.

Under data parallelism (``parallel/ddp.py``) each rank holds some rows of
the global batch.  So that every sample sees the draws it would see in one
process, an engine's loss makes each draw at the global batch's size from
the step's generator and keeps this rank's rows (:class:`Rows`).  The
engines draw through it in one process too, with :meth:`Rows.whole`, so
the order of the draws lives in the engine alone.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    """Rows ``[start, start + count)`` of a leading axis of ``total`` rows,
    zero-padded to ``size`` rows (this rank's padded batch; ``count`` when
    None)."""

    start: int
    count: int
    total: int
    size: int | None = None

    @classmethod
    def whole(cls, n: int) -> "Rows":
        """All ``n`` rows: one process."""
        return cls(0, n, n)

    def cut(self, draw: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``draw`` (``total`` rows), padded with zeros."""
        rows = draw[self.start: self.start + self.count]
        if self.size is None or self.size == self.count:
            return rows
        out = draw.new_zeros((self.size, *draw.shape[1:]))
        out[: self.count] = rows
        return out

    def rand(self, generator: torch.Generator | None, device, trailing: tuple = (),
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Uniform [0, 1) draws of shape (total, *trailing), cut."""
        return self.cut(torch.rand((self.total, *trailing), generator=generator, device=device, dtype=dtype))

    def randn(self, generator: torch.Generator | None, device, trailing: tuple = (),
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Standard normal draws of shape (total, *trailing), cut."""
        return self.cut(torch.randn((self.total, *trailing), generator=generator, device=device, dtype=dtype))
