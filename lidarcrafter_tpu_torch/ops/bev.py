"""BEV xy-histograms of a point cloud, on the cloud's device.

Port of the JAX package's ``ops/bev.py``: ``torch.histogramdd`` semantics,
``bins`` equal-width bins over [-bound, bound] per axis with the last edge
right-inclusive.  The segment sum becomes one ``index_add_`` (no host
sync, unlike ``bincount`` on the card).

XLA compiles a division by a constant into a product with its float32
reciprocal, and :func:`times_reciprocal` does the same, so that a point on a
bin edge lands in the JAX package's bin, on the card and on the CPU alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .projection import norm3


def times_reciprocal(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as XLA computes it: ``x`` times the float32 ``1 / c``."""
    return x * float(np.float32(1) / np.float32(c))


def point_cloud_to_histogram(
    point_cloud: torch.Tensor,
    mask: torch.Tensor | None = None,
    field_size: float = 160.0,
    bins: int = 100,
    min_depth: float = 3.0,
    max_depth: float = 70.0,
) -> torch.Tensor:
    """(N, 3) [+ optional (N,) validity mask] → (bins, bins) float32
    histogram."""
    if bins % 2:
        raise ValueError(f"bins must be even, got {bins}")
    depth = norm3(point_cloud[:, :3])
    valid = (depth > min_depth) & (depth < max_depth)
    if mask is not None:
        valid &= mask
    bound = field_size / 2
    xy = point_cloud[:, 0:2]
    ij = torch.floor(times_reciprocal(xy + bound, field_size / bins)).to(torch.int64)
    # histogramdd: the right edge of the last bin is inclusive
    ij = torch.where((xy == bound) & (ij == bins), bins - 1, ij)
    in_range = ((xy >= -bound) & (xy <= bound)).all(dim=1) & valid
    flat = torch.where(in_range, ij[:, 0] * bins + ij[:, 1], bins * bins)
    hist = point_cloud.new_zeros(bins * bins + 1, dtype=torch.float32)
    hist.index_add_(0, flat, in_range.to(torch.float32))
    return hist[: bins * bins].reshape(bins, bins)
