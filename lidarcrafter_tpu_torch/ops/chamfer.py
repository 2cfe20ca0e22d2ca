"""Chamfer distance (2D / 3D), chunked and masked, on the clouds' device.

Port of the JAX package's ``ops/chamfer.py``, which replaces upstream's
CUDA chamfer op: squared nearest-neighbour distances in both directions and
their argmin indices.  Queries go in chunks, so no full N×M matrix is ever
built.  Distances use the exact-difference form Σ_d (x_d − y_d)²,
accumulated over the coordinates in order with a fused multiply-add (as
XLA:CPU reduces them), not ``torch.cdist`` or the matmul expansion:
near-zero distances and argmin ties then agree with the JAX package.
"""

from __future__ import annotations

import torch

_BIG = 1e10  # squared distance to a masked point


def nn_chunked(
    x: torch.Tensor,
    y: torch.Tensor,
    y_mask: torch.Tensor | None = None,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each point of ``x`` (B, N, D): the least squared distance to the
    (masked) points of ``y`` (B, M, D) and its lowest index, (B, N) each."""
    dists, idxs = [], []
    for start in range(0, x.shape[1], chunk):
        xq = x[:, start : start + chunk]
        d2 = (xq[:, :, None, 0] - y[:, None, :, 0]).square_()
        for d in range(1, x.shape[2]):
            diff = xq[:, :, None, d] - y[:, None, :, d]
            d2.addcmul_(diff, diff)
        if y_mask is not None:
            d2.masked_fill_(~y_mask[:, None, :], _BIG)
        dist, idx = torch.min(d2, dim=2)  # first index of the minimum
        dists.append(dist)
        idxs.append(idx)
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def chamfer_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, D) × (B, M, D) → (dist1 (B, N), dist2 (B, M), idx1, idx2).

    Squared distances, as upstream's ``chamfer_3DDist``; D is 2 or 3.
    Masked-out points get distance 0, so that masked means stay right.
    """
    d1, i1 = nn_chunked(x, y, y_mask, chunk)
    d2, i2 = nn_chunked(y, x, x_mask, chunk)
    if x_mask is not None:
        d1 = torch.where(x_mask, d1, 0.0)
    if y_mask is not None:
        d2 = torch.where(y_mask, d2, 0.0)
    return d1, d2, i1, i2


def chamfer_metric(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: torch.Tensor | None = None,
    y_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The eval suite's scalar CD: (mean(dist1) + mean(dist2)) / 2, with
    masked means; a 0-dim tensor on the clouds' device."""
    d1, d2, _, _ = chamfer_distance(x, y, x_mask, y_mask)
    m1 = d1.mean() if x_mask is None else d1.sum() / x_mask.sum().clamp(min=1)
    m2 = d2.mean() if y_mask is None else d2.sum() / y_mask.sum().clamp(min=1)
    return (m1 + m2) / 2
