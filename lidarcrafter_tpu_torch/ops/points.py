"""Irregular point-cloud ops with fixed shapes and validity masks.

Port of the JAX package's ``ops/points.py`` (upstream's pointnet2 and
roiaware_pool3d kernels, dense and masked):

- ``points_in_boxes``: boxes ``[x, y, z, dx, dy, dz, heading]`` with z at
  the box centre, a margin of 1e-5 on x and y, ``<=`` on z.
- ``farthest_point_sampling``: from index 0, the running least distance,
  ties to the first index; masked points never win.
- ``ball_query``: the first ``nsample`` points in index order within the
  radius, empty slots filled with the first hit (else 0).
- ``knn`` / ``three_nn`` / ``three_interpolate``, ``gather_points`` /
  ``group_points`` / ``query_and_group``.
"""

from __future__ import annotations

import torch


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """``points`` (..., N, 3) and ``boxes`` (..., M, 7) → (..., M, N) bool."""
    shift = points[..., None, :, :3] - boxes[..., :, None, :3]  # (..., M, N, 3)
    rz = boxes[..., 6, None]
    cosa, sina = torch.cos(-rz), torch.sin(-rz)
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    margin = 1e-5
    in_z = torch.abs(shift[..., 2]) <= boxes[..., 5, None] / 2.0
    in_x = torch.abs(local_x) < boxes[..., 3, None] / 2.0 + margin
    in_y = torch.abs(local_y) < boxes[..., 4, None] / 2.0 + margin
    return in_z & in_x & in_y


def _ones_mask(xyz: torch.Tensor) -> torch.Tensor:
    return torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)


def farthest_point_sampling(xyz: torch.Tensor, num_samples: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) → (B, num_samples) int32 indices, starting at index 0."""
    B, N, _ = xyz.shape
    mask = _ones_mask(xyz) if mask is None else mask
    min_d = xyz.new_full((B, N), 1e10)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    out = [last]
    rows = torch.arange(B, device=xyz.device)
    for _ in range(num_samples - 1):
        d = ((xyz - xyz[rows, last][:, None]) ** 2).sum(-1)
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(torch.where(mask, min_d, -1.0), dim=1)
        out.append(last)
    return torch.stack(out, 1).to(torch.int32)


def ball_query(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float, nsample: int,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, M, 3) × (B, N, 3) → (B, M, nsample) int32."""
    mask = _ones_mask(xyz) if mask is None else mask
    d2 = ((new_xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    hit = (d2 < radius * radius) & mask[:, None, :]
    slot = torch.cumsum(hit, dim=2) - 1
    take = hit & (slot < nsample)
    B, M, N = hit.shape
    first = torch.argmax(hit.to(torch.int8), dim=2)  # 0 when nothing is in the radius
    out = first[..., None].expand(B, M, nsample + 1).clone()  # the last column takes the dropped writes
    k_ids = torch.arange(N, device=xyz.device).expand(B, M, N)
    out.scatter_(2, torch.where(take, slot, nsample), torch.where(take, k_ids, first[..., None]))
    return out[..., :nsample].to(torch.int32)


def knn(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int, mask: torch.Tensor | None = None):
    """k nearest neighbours: (B, M, 3) × (B, N, 3) → (squared distances
    (B, M, k), int32 indices); masked points are at +inf, ties go to the
    lower index."""
    mask = _ones_mask(xyz) if mask is None else mask
    d2 = ((new_xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(mask[:, None, :], d2, torch.inf)
    d, idx = torch.sort(d2, dim=2, stable=True)
    return d[..., :k], idx[..., :k].to(torch.int32)


def three_nn(new_xyz: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor | None = None):
    """(distances (B, M, 3), not squared; indices (B, M, 3))."""
    d2, idx = knn(new_xyz, xyz, 3, mask)
    return torch.sqrt(d2), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """features (B, C, N), idx / weight (B, M, 3) → (B, C, M) = Σ_k w_k · f[:, idx_k]."""
    return (group_points(features, idx) * weight[:, None]).sum(-1)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights for :func:`three_interpolate`: (1/d) / Σ(1/d)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(-1, keepdim=True)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, C, N) × (B, M) → (B, C, M)."""
    return features.gather(2, idx.long()[:, None, :].expand(-1, features.shape[1], -1))


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, C, N) × (B, M, K) → (B, C, M, K)."""
    B, M, K = idx.shape
    return gather_points(features, idx.reshape(B, M * K)).reshape(B, -1, M, K)


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor, features: torch.Tensor | None, radius: float,
                    nsample: int, use_xyz: bool = True, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Ball query and grouping with centred xyz: (B, 3[+C], M, nsample)."""
    idx = ball_query(new_xyz, xyz, radius, nsample, mask)
    grouped_xyz = group_points(xyz.transpose(1, 2), idx) - new_xyz.transpose(1, 2)[..., None]
    if features is None:
        return grouped_xyz
    grouped = group_points(features, idx)
    return torch.cat([grouped_xyz, grouped], 1) if use_xyz else grouped
