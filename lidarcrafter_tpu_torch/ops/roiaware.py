"""RoI-aware 3D pooling: per-box voxel grids of point features.

Port of the JAX package's ``ops/roiaware.py`` (upstream's
``roiaware_pool3d``): the points inside each rotated box are binned into an
(ox, oy, oz) grid in the box's frame and max- or mean-pooled per bin, over
fixed shapes (a scatter-reduce per box instead of atomics).
"""

from __future__ import annotations

import torch

from .points import points_in_boxes


def roiaware_pool3d(rois: torch.Tensor, pts: torch.Tensor, pts_feature: torch.Tensor, out_size=7,
                    pool_method: str = "max", pts_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 7) rois × (P, 3) points × (P, C) features → (N, ox, oy, oz, C);
    bins clamped into the grid, empty bins 0."""
    ox, oy, oz = (out_size,) * 3 if isinstance(out_size, int) else out_size
    N, P, C = rois.shape[0], pts.shape[0], pts_feature.shape[1]
    member = points_in_boxes(pts, rois)
    if pts_mask is not None:
        member &= pts_mask[None]
    shift = pts[None, :, :3] - rois[:, None, :3]
    rz = rois[:, 6, None]
    c, s = torch.cos(-rz), torch.sin(-rz)
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    lz = shift[..., 2]
    dx, dy, dz = rois[:, 3, None], rois[:, 4, None], rois[:, 5, None]
    xi = ((lx + dx / 2) / (dx / ox)).to(torch.int32).clamp(0, ox - 1)
    yi = ((ly + dy / 2) / (dy / oy)).to(torch.int32).clamp(0, oy - 1)
    zi = ((lz + dz / 2) / (dz / oz)).to(torch.int32).clamp(0, oz - 1)
    V = ox * oy * oz
    seg = torch.where(member, (xi * oy + yi) * oz + zi, V).long()  # (N, P); V takes the points outside
    index = seg[..., None].expand(N, P, C)
    feats = pts_feature[None].expand(N, P, C)
    if pool_method == "max":
        pooled = pts_feature.new_full((N, V + 1, C), -torch.inf).scatter_reduce_(1, index, feats, "amax")[:, :V]
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    else:
        sums = pts_feature.new_zeros(N, V + 1, C).scatter_add_(1, index, feats)[:, :V]
        counts = pts_feature.new_zeros(N, V + 1).scatter_add_(1, seg, member.to(pts_feature.dtype))[:, :V]
        pooled = sums / torch.clamp(counts, min=1.0)[..., None]
    return pooled.reshape(N, ox, oy, oz, C)
