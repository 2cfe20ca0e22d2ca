"""A data-parallel rank's share of a training step's random draws.

Under data parallelism (``parallel/ddp.py``) each rank holds some rows of
the global batch.  So that every sample sees the draws it would see in one
process, an engine's loss makes each draw at the global batch's size from
the step's generator and keeps this rank's rows (:class:`Rows`).  The
engines draw through it in one process too, with :meth:`Rows.whole`, so
the order of the draws lives in the engine alone.

Under the azimuth axis (``parallel/mesh.py``, ``sp``) a rank holds some
columns of each image too: a :class:`Columns` window on its :class:`Rows`
makes each image draw at the global width and keeps the rank's columns, so
that every pixel sees the draw it would see in one process.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Columns:
    """Columns ``[start, start + count)`` of axis ``axis`` (of the whole
    draw, rows first: 2 is the W of an NHWC image) of ``total`` columns."""

    start: int
    count: int
    total: int
    axis: int = 2


@dataclasses.dataclass(frozen=True)
class Rows:
    """Rows ``[start, start + count)`` of a leading axis of ``total`` rows,
    zero-padded to ``size`` rows (this rank's padded batch; ``count`` when
    None), and with ``cols`` the window of columns the rank holds of a draw
    with trailing dimensions (a per-row draw, such as the timesteps, is
    whole)."""

    start: int
    count: int
    total: int
    size: int | None = None
    cols: Columns | None = None

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

    def _whole_trailing(self, trailing: tuple) -> tuple:
        """The trailing shape of the whole draw of which a rank's sample
        has ``trailing``: the window's axis at its total width."""
        if self.cols is None or not trailing:
            return tuple(trailing)
        trailing = list(trailing)
        trailing[self.cols.axis - 1] = self.cols.total
        return tuple(trailing)

    def _cut_columns(self, draw: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a whole draw with trailing dimensions."""
        if self.cols is None or draw.ndim == 1:
            return draw
        return draw.narrow(self.cols.axis, self.cols.start, self.cols.count)

    def rand(self, generator: torch.Generator | None, device, trailing: tuple = (),
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Uniform [0, 1) draws of shape (total, *trailing), cut; under a
        column window ``trailing`` is a rank's and the draw is whole."""
        draw = torch.rand((self.total, *self._whole_trailing(trailing)), generator=generator, device=device,
                          dtype=dtype)
        return self.cut(self._cut_columns(draw))

    def randint(self, high: int, generator: torch.Generator | None, device) -> torch.Tensor:
        """Integer draws uniform in [0, ``high``), one a row (``total``),
        cut (the discrete engine's timesteps)."""
        return self.cut(torch.randint(0, high, (self.total,), generator=generator, device=device))

    def randn(self, generator: torch.Generator | None, device, trailing: tuple = (),
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Standard normal draws of shape (total, *trailing), cut; under a
        column window ``trailing`` is a rank's and the draw is whole."""
        draw = torch.randn((self.total, *self._whole_trailing(trailing)), generator=generator, device=device,
                           dtype=dtype)
        return self.cut(self._cut_columns(draw))
