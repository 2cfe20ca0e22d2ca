"""LiDAR geometry: depth codec, [-1, 1] normalisation, range → xyz.

Port of the JAX package's ``utils/lidar.py`` (``LiDARUtility``,
``get_linear_ray_angles_np``, ``nearest_interp_2d``).  Images are NHWC ``(B, H, W, C)``; ray angles
are ``(H, W, 2)`` radians with channel 0 = elevation and channel 1 = azimuth.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_linear_ray_angles_np(
    H: int = 64,
    W: int = 2048,
    fov_up: float = 10.0,
    fov_down: float = -30.0,
    dtype=np.float64,
) -> np.ndarray:
    """Host-side linear ray angles ``(H, W, 2)`` in radians."""
    w_left, w_right = 180.0, -180.0
    elevation = 1.0 - np.arange(H, dtype=dtype) / H
    elevation = elevation * (fov_up - fov_down) + fov_down
    azimuth = 1.0 - np.arange(W, dtype=dtype) / W
    azimuth = azimuth * (w_left - w_right) + w_right
    elev, azim = np.meshgrid(elevation, azimuth, indexing="ij")
    angles = np.stack([elev, azim], axis=-1)
    return np.deg2rad(angles)


@dataclasses.dataclass(frozen=True)
class LiDARUtility:
    """Depth codecs and range→xyz on NHWC tensors."""

    ray_angles: torch.Tensor  # (H, W, 2) radians, float32
    resolution: tuple[int, int]
    depth_format: str
    min_depth: float
    max_depth: float

    @classmethod
    def create(
        cls,
        resolution: tuple[int, int],
        depth_format: str,
        min_depth: float,
        max_depth: float,
        fov_up: float = 10.0,
        fov_down: float = -30.0,
        device: str | torch.device = "cpu",
        ray_angles: np.ndarray | torch.Tensor | None = None,
    ) -> "LiDARUtility":
        """Linear ray angles from the field of view, or the given
        ``ray_angles`` (H', W', 2), resampled to ``resolution`` with
        :func:`nearest_interp_2d` where their size differs."""
        if depth_format not in ("log_depth", "inverse_depth", "depth"):
            raise ValueError(depth_format)
        if ray_angles is None:
            ray_angles = get_linear_ray_angles_np(
                *resolution, fov_up=fov_up, fov_down=fov_down, dtype=np.float32
            )
        angles = torch.as_tensor(ray_angles, dtype=torch.float32)
        if angles.ndim != 3 or angles.shape[-1] != 2:
            raise ValueError(f"ray angles of shape {tuple(angles.shape)}, expected (H, W, 2)")
        if tuple(angles.shape[:2]) != tuple(resolution):
            angles = nearest_interp_2d(angles, resolution)
        return cls(
            ray_angles=angles.to(device),
            resolution=tuple(resolution),
            depth_format=depth_format,
            min_depth=float(min_depth),
            max_depth=float(max_depth),
        )

    @staticmethod
    def denormalize(x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] → [0, 1]."""
        return (x + 1) / 2

    @staticmethod
    def normalize(x: torch.Tensor) -> torch.Tensor:
        """[0, 1] → [-1, 1]."""
        return x * 2 - 1

    def get_mask(self, metric: torch.Tensor) -> torch.Tensor:
        mask = (metric > self.min_depth) & (metric < self.max_depth)
        return mask.to(metric.dtype)

    def convert_depth(
        self, metric: torch.Tensor, mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Metric depth [0, max_depth] → normalized [0, 1]."""
        if mask is None:
            mask = self.get_mask(metric)
        if self.depth_format == "log_depth":
            normalized = torch.log2(metric + 1) / math.log2(self.max_depth + 1)
        elif self.depth_format == "inverse_depth":
            normalized = self.min_depth / (metric + 1e-8)
        else:
            normalized = metric / self.max_depth
        return torch.clamp(normalized, 0.0, 1.0) * mask

    def revert_depth(self, normalized: torch.Tensor) -> torch.Tensor:
        """Normalized depth [0, 1] → metric [0, max_depth]."""
        if self.depth_format == "log_depth":
            metric = torch.exp2(normalized * math.log2(self.max_depth + 1)) - 1
        elif self.depth_format == "inverse_depth":
            metric = self.min_depth / (normalized + 1e-8)
        else:
            metric = normalized * self.max_depth
        return metric * self.get_mask(metric)

    def to_xyz(self, metric: torch.Tensor) -> torch.Tensor:
        """Range image (B, H, W, 1) → cartesian (B, H, W, 3)."""
        if metric.ndim != 4:
            raise ValueError(f"expected (B, H, W, 1), got {tuple(metric.shape)}")
        mask = self.get_mask(metric)
        angles = self.ray_angles.to(metric.device)
        phi = angles[None, ..., 0:1]
        theta = angles[None, ..., 1:2]
        grid_x = metric * torch.cos(phi) * torch.cos(theta)
        grid_y = metric * torch.cos(phi) * torch.sin(theta)
        grid_z = metric * torch.sin(phi)
        return torch.cat([grid_x, grid_y, grid_z], dim=-1) * mask


def nearest_interp_2d(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """'nearest-exact' resize over the first two dims of an (H, W, C)
    tensor: output index i reads floor((i + 0.5) · in / out)."""
    H, W = x.shape[:2]
    out_h, out_w = size
    rows = np.clip(np.floor((np.arange(out_h) + 0.5) * (H / out_h)).astype(np.int64), 0, H - 1)
    cols = np.clip(np.floor((np.arange(out_w) + 0.5) * (W / out_w)).astype(np.int64), 0, W - 1)
    return x[torch.as_tensor(rows, device=x.device)][:, torch.as_tensor(cols, device=x.device)]
