"""BEV histogram metrics: JSD and RBF-kernel MMD, and voxel-occupancy BEV
grids.

Port of the JAX package's ``metrics/bev.py``: the grids are built on the
cloud's device (``ops.bev.point_cloud_to_histogram`` or
:func:`bev_occupancy_grid`, whose segment max is one ``scatter_reduce``),
and the divergences are tensor code on the histograms' device.
"""

from __future__ import annotations

import math

import torch

from ..ops.bev import times_reciprocal
from . import DATA_CONFIG, VOXEL_SIZE


def _kl(p, q, eps=1e-12):
    return torch.where(p > 0, p * (torch.log(p + eps) - torch.log(q + eps)), 0.0).sum()


def jensen_shannon_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``scipy.spatial.distance.jensenshannon``: the square root of the JS
    divergence, natural log."""
    p = p / p.sum()
    q = q / q.sum()
    m = (p + q) / 2
    js = (_kl(p, m) + _kl(q, m)) / 2
    return torch.sqrt(js.clamp(min=0.0))


def cdist_rbf(p: torch.Tensor, q: torch.Tensor, sigma: float = 0.5) -> torch.Tensor:
    """RBF kernel matrix of the rows of ``p`` and ``q``."""
    d2 = (p**2).sum(1)[:, None] + (q**2).sum(1)[None] - 2 * p @ q.T
    gamma = 1.0 / (2 * sigma**2)
    return torch.exp(-gamma * d2.clamp(min=0.0))


def compute_jsd_2d(hist1: torch.Tensor, hist2: torch.Tensor) -> float:
    """JSD of the histograms pooled over the samples."""
    p = hist1.reshape(hist1.shape[0], -1).sum(0)
    q = hist2.reshape(hist2.shape[0], -1).sum(0)
    return float(jensen_shannon_distance(p, q))


def compute_mmd_2d(hist1: torch.Tensor, hist2: torch.Tensor) -> float:
    """RBF-kernel MMD of the per-sample normalised histograms."""
    p = hist1.reshape(hist1.shape[0], -1)
    q = hist2.reshape(hist2.shape[0], -1)
    p = p / p.sum(1, keepdim=True)
    q = q / q.sum(1, keepdim=True)
    mmd = cdist_rbf(p, p).mean() + cdist_rbf(q, q).mean() - 2 * cdist_rbf(p, q).mean()
    return float(mmd)


def bev_grid_shape(data_type: str, voxel_size: float = VOXEL_SIZE):
    cfg = DATA_CONFIG[data_type]
    x_range, y_range = cfg["x"], cfg["y"]
    shape = (
        math.ceil((x_range[1] - x_range[0]) / voxel_size),
        math.ceil((y_range[1] - y_range[0]) / voxel_size),
    )
    min_bound = (
        math.ceil(x_range[0] / voxel_size),
        math.ceil(y_range[0] / voxel_size),
    )
    return shape, min_bound, x_range, y_range


def bev_occupancy_grid(
    pcd: torch.Tensor,
    mask: torch.Tensor | None = None,
    data_type: str = "32",
    voxel_size: float = VOXEL_SIZE,
) -> torch.Tensor:
    """Voxel-unique BEV grid of one (N, ≥2) cloud: each occupied voxel
    counts exactly 1 (upstream dedupes voxels before summing)."""
    (H, W), (minx, miny), x_range, y_range = bev_grid_shape(data_type, voxel_size)
    valid = (
        (pcd[:, 0] > x_range[0])
        & (pcd[:, 0] < x_range[1])
        & (pcd[:, 1] > y_range[0])
        & (pcd[:, 1] < y_range[1])
    )
    if mask is not None:
        valid &= mask
    vx = (torch.floor(times_reciprocal(pcd[:, 0], voxel_size)).to(torch.int64) - minx).clamp(0, H - 1)
    vy = (torch.floor(times_reciprocal(pcd[:, 1], voxel_size)).to(torch.int64) - miny).clamp(0, W - 1)
    flat = torch.where(valid, vx * W + vy, H * W)
    grid = pcd.new_zeros(H * W + 1, dtype=torch.float32)
    grid = grid.scatter_reduce_(0, flat, valid.to(torch.float32), "amax")[: H * W]
    return grid.clamp(0.0, 1.0).reshape(H, W)


def compute_jsd_bev(reference_clouds, sample_clouds, data_type: str = "32",
                    device: str | torch.device = "cuda") -> float:
    """Scene-set JSD of the summed occupancy grids of two lists of clouds."""
    def grids(clouds):
        return sum(bev_occupancy_grid(torch.as_tensor(p, device=device), data_type=data_type) for p in clouds)

    return float(jensen_shannon_distance(grids(reference_clouds).reshape(-1), grids(sample_clouds).reshape(-1)))
