"""Dataset-side transforms: the port of the JAX package's
``datasets/transforms.py``.

:func:`rotate_points_along_z` is the device path (torch, the JAX
``rotate_points_along_z_jnp``); everything else is host code in numpy, as
in the JAX package: the box codecs of the layout and object branches
(``scale_boxes_3d``, ``unscale_boxes_3d``, ``encoding_boxes_3d``,
``object_encoding_boxes_3d``, ``norm_fg_points``, ``unnorm_fg_points``),
the 13-slot box padding (``align_box_num``), the point filters of the
datasets (``remove_ego_points``, ``delete_ground_points``), the object
branch's resampling (``sample_points``, drawing from an explicit
``np.random.RandomState``) and its validity test (``object_is_valid``).
"""

from __future__ import annotations

import numpy as np
import torch

POINTS_RANGE = (-80.0, -80.0, -8.0, 80.0, 80.0, 8.0)

# nuScenes lidarseg labels → training labels; labels 10 and 12 are ground
NUSC_LEARNING_MAP = {
    0: -1, 1: -1, 2: 6, 3: 6, 4: 6, 5: -1, 6: 6, 7: -1, 8: -1, 9: 0,
    10: -1, 11: -1, 12: 7, 13: -1, 14: 1, 15: 2, 16: 2, 17: 3, 18: 4,
    19: -1, 20: -1, 21: 5, 22: 8, 23: 9, 24: 10, 25: 11, 26: 12, 27: 13,
    28: 14, 29: -1, 30: 15, 31: -1,
}
GROUND_LABELS = (10, 12)


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


def remove_ego_points(points: np.ndarray, center_radius: float = 1.0) -> np.ndarray:
    """The points outside the ``center_radius`` square around the ego."""
    mask = ~((np.abs(points[:, 0]) < center_radius) & (np.abs(points[:, 1]) < center_radius))
    return points[mask]


def delete_ground_points(points: np.ndarray, segment: np.ndarray) -> np.ndarray:
    """The points whose lidarseg label (``segment``, one uint8 a point) does
    not map to a ground label (driveable surface, other flat)."""
    lut = np.full(32, -1, np.int64)
    for k, v in NUSC_LEARNING_MAP.items():
        lut[k] = v
    mapped = lut[segment]
    return points[(mapped != GROUND_LABELS[0]) & (mapped != GROUND_LABELS[1])]


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


def encoding_boxes_3d(box_3d: np.ndarray, unique_mode: bool = True, points_range=POINTS_RANGE) -> np.ndarray:
    """One box's condition encoding: distance and height of the normalised
    centre, log sizes, then the yaw relative to the bearing (``unique_mode``,
    (6,)) or the bearing in [0, 1) with (sin, cos) of the yaw ((8,))."""
    x, y, z, w, h, l, yaw = np.asarray(box_3d[:7], np.float64)
    out = np.zeros(8, np.float32)
    out[0] = np.hypot(x / (0 - points_range[0]), y / (0 - points_range[1]))
    out[1] = z / (0 - points_range[2])
    out[2:5] = np.log(np.array([w, h, l]) + 1e-6)
    if unique_mode:
        out[5] = yaw - np.arctan2(y, x)
        return out[:6]
    out[5] = (-np.arctan2(y, x) / np.pi + 1) / 2 % 1
    out[6] = np.sin(yaw)
    out[7] = np.cos(yaw)
    return out


def align_box_num(bbox_3d: np.ndarray, bbox_2d: np.ndarray, fg_encoding_box: np.ndarray, expect_box_num: int = 13):
    """Boxes, 2D boxes and encodings cut or zero-padded to
    ``expect_box_num`` slots, with the (expect_box_num,) validity of each
    slot."""
    n = bbox_3d.shape[0]
    if n > expect_box_num:
        return bbox_3d[:expect_box_num], bbox_2d[:expect_box_num], fg_encoding_box[:expect_box_num], \
            np.ones(expect_box_num)

    def pad(a):
        out = np.zeros((expect_box_num, a.shape[-1]), a.dtype)
        out[:n] = a
        return out

    valid = np.zeros(expect_box_num)
    valid[:n] = 1
    return pad(bbox_3d), pad(bbox_2d), pad(fg_encoding_box), valid


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


def sample_points(points: np.ndarray, num_samples: int, rng: np.random.RandomState) -> np.ndarray:
    """``num_samples`` of the points, drawn from ``rng``: with replacement
    when there are too few; otherwise without, keeping every point beyond
    0.1 m of the box centre when they are fewer than ``num_samples``."""
    N = len(points)
    if N <= num_samples:
        return points[rng.choice(N, num_samples, replace=True)]
    pts_depth = np.linalg.norm(points[:, :3], axis=1)
    near = np.where(pts_depth < 0.1)[0]
    far = np.where(pts_depth >= 0.1)[0]
    if num_samples > len(far):
        near_choice = rng.choice(near, num_samples - len(far), replace=False)
        choice = np.concatenate([near_choice, far]) if len(far) > 0 else near_choice
    else:
        choice = rng.choice(np.arange(N), num_samples, replace=False)
    rng.shuffle(choice)
    return points[choice]


def object_is_valid(num_points_in_gt: int, box3d, points_range=POINTS_RANGE) -> bool:
    """An object trains when it holds at least 50 points and its centre lies
    in ``points_range``."""
    if num_points_in_gt < 50:
        return False
    return (
        points_range[0] <= box3d[0] <= points_range[3]
        and points_range[1] <= box3d[1] <= points_range[4]
        and points_range[2] <= box3d[2] <= points_range[5]
    )
