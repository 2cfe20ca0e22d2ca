"""Point rotation about z: the port of ``rotate_points_along_z_jnp`` from the
JAX package's ``datasets/transforms.py`` (the other dataset transforms wait
for the dataset pipeline)."""

from __future__ import annotations

import torch


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(..., N, 3+C) points rotated by the (...) ``angle``: p' = p @ R with
    R = [[c, s, 0], [-s, c, 0], [0, 0, 1]], written out as multiply-adds in
    the matrix product's order; the extra channels pass through."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xyz = torch.stack([x * c - y * s, x * s + y * c, points[..., 2]], dim=-1)
    return torch.cat([xyz, points[..., 3:]], dim=-1)
