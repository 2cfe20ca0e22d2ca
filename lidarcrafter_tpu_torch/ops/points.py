"""Rotated-box membership of points.

Port of ``points_in_boxes`` from the JAX package's ``ops/points.py`` (the
counterpart of roiaware_pool3d's ``check_pt_in_box3d``): boxes are
``[x, y, z, dx, dy, dz, heading]`` with z at the box centre, a margin of
1e-5 on x and y, and ``<=`` on z.  Dense and batched: every point against
every box, no data-dependent shapes.  Farthest-point sampling, ball query
and kNN wait for the metrics.
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
