"""Dataset-side transforms: the port of the JAX package's
``datasets/transforms.py`` functions that the port runs.

:func:`rotate_points_along_z` is the device path (torch, the JAX
``rotate_points_along_z_jnp``); the box codecs of the layout and object
branches (``scale_boxes_3d``, ``unscale_boxes_3d``,
``object_encoding_boxes_3d``, ``norm_fg_points``, ``unnorm_fg_points``) are
host code in numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

POINTS_RANGE = (-80.0, -80.0, -8.0, 80.0, 80.0, 8.0)


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(..., N, 3+C) points rotated by the (...) ``angle``: p' = p @ R with
    R = [[c, s, 0], [-s, c, 0], [0, 0, 1]], written out as multiply-adds in
    the matrix product's order; the extra channels pass through."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xyz = torch.stack([x * c - y * s, x * s + y * c, points[..., 2]], dim=-1)
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def _rotate_points_along_z_np(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """(B, N, 3+C) numpy points rotated by the (B,) ``angle``, as one matrix
    product (the host path's convention)."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(cosa), np.ones_like(cosa)
    rot = np.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=1).reshape(-1, 3, 3)
    out = points.copy()
    out[..., :3] = np.matmul(points[..., :3], rot)
    return out


def scale_boxes_3d(boxes_3d: np.ndarray, points_range=POINTS_RANGE) -> np.ndarray:
    """(N, ≥7) metric boxes → (N, D+1): centre over the range's negative
    half, log sizes, (sin, cos) of the yaw, the extra columns after."""
    boxes_3d = np.asarray(boxes_3d, np.float64).copy()
    n, d = boxes_3d.shape
    out = np.zeros((n, d + 1))
    for i in range(3):
        out[:, i] = boxes_3d[:, i] / (0 - points_range[i])
    out[:, 3:6] = np.log(boxes_3d[:, 3:6] + 1e-6)
    out[:, 6] = np.sin(boxes_3d[:, 6])
    out[:, 7] = np.cos(boxes_3d[:, 6])
    if d > 7:
        out[:, 8:] = boxes_3d[:, 7:]
    return out


def unscale_boxes_3d(boxes_3d_traj: np.ndarray, points_range=POINTS_RANGE):
    """(N, 8 + 12) scaled boxes and trajectories → ((N, 7) metric boxes,
    (N, 6, 2) trajectories).  Row 0 (the ego node of a single scene) is
    zeroed, whatever the input holds."""
    scaled = np.asarray(boxes_3d_traj[:, :8], np.float64)
    trajs = np.asarray(boxes_3d_traj[:, 8:], np.float64)
    n = scaled.shape[0]
    out = np.zeros((n, 7))
    for i in range(3):
        out[:, i] = scaled[:, i] * (0 - points_range[i])
    out[:, 3:6] = np.exp(scaled[:, 3:6])
    out[:, 6] = np.arctan2(scaled[:, 6], scaled[:, 7])
    out[0, :] = 0
    return out, trajs.reshape(n, 6, 2)


def object_encoding_boxes_3d(box_3d: np.ndarray, points_range=POINTS_RANGE) -> np.ndarray:
    """The object branch's (6,) box encoding: distance of the min-max
    normalised centre, its height, log sizes, yaw relative to the bearing."""
    x, y, z, w, h, l, yaw = np.asarray(box_3d[:7], np.float64)
    x_min, y_min, z_min, x_max, y_max, z_max = points_range
    out = np.zeros(6, np.float32)
    x_norm = (x - x_min) / (x_max - x_min)
    y_norm = (y - y_min) / (y_max - y_min)
    out[0] = np.hypot(x_norm, y_norm)
    out[1] = (z - z_min) / (z_max - z_min)
    out[2:5] = np.log(np.array([w, h, l]) + 1e-6)
    out[5] = yaw - np.arctan2(y, x)
    return out


def norm_fg_points(fg_points: np.ndarray, box3d: np.ndarray) -> np.ndarray:
    """Centre-relative (N, 4) object points → the box frame: rotated by
    the box's −yaw, divided by its half sizes, intensity from [0, 255] to
    [−1, 1]; the inverse of :func:`unnorm_fg_points`."""
    out = _rotate_points_along_z_np(fg_points[np.newaxis], -np.asarray([box3d[6]], np.float64))[0]
    out[:, 0] = 2 * out[:, 0] / box3d[3]
    out[:, 1] = 2 * out[:, 1] / box3d[4]
    out[:, 2] = 2 * out[:, 2] / box3d[5]
    out[:, 3] = 2 * (out[:, 3] / 255.0) - 1
    return out


def unnorm_fg_points(obj_points: np.ndarray, box3d: np.ndarray) -> np.ndarray:
    """Box-frame (N, 4) object points → scene points: sizes and intensity
    undone, rotated by the box's yaw, moved to its centre."""
    out = obj_points.copy()
    out[:, 0] = out[:, 0] * box3d[3] / 2.0
    out[:, 1] = out[:, 1] * box3d[4] / 2.0
    out[:, 2] = out[:, 2] * box3d[5] / 2.0
    out[:, 3] = 255 * (out[:, 3] + 1) / 2
    out = _rotate_points_along_z_np(out[np.newaxis], np.asarray([box3d[6]], np.float64))[0]
    out[:, :3] += np.asarray(box3d[:3])[None]
    return out
