"""The 4D rollout's geometry: trajectories, ego-motion warps and point ops.

Port of the JAX package's ``datasets/rollout.py``.  The trajectory helpers
(``interp_trajs``, ``expand_future_trajs``, ``compute_inter_frame_transforms``)
are host numpy, copied as they are.  The point ops work on padded clouds
batched over scenes: points (S, N, 4) ``[x, y, z, intensity]`` with an
(S, N) bool mask, boxes (S, K, 7) ``[x, y, z, dx, dy, dz, yaw]`` with an
(S, K) bool mask.  They are masks, sorts and gathers at fixed shapes, with
no host sync, and keep the JAX package's point order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.points import points_in_boxes
from ..ops.projection import convert_boxes_to_2d, norm3, points_to_range_image
from .transforms import rotate_points_along_z

# ------------------------------------------------------------- trajectories


def interp_trajs(trajs: np.ndarray, M: int) -> np.ndarray:
    """Linear resampling of (K, N, 2) trajectories to (K, M, 2): for each
    target time u on the uniform grid, ``(1-w)·traj[lo] + w·traj[lo+1]``."""
    _, N, _ = trajs.shape
    if N == 1:  # constant extension, like np.interp on a single knot
        return np.repeat(trajs, M, axis=1).astype(trajs.dtype)
    pos = np.linspace(0.0, float(N - 1), M)
    lo = np.minimum(pos.astype(np.int64), N - 2)
    w = (pos - lo)[None, :, None]
    return ((1.0 - w) * trajs[:, lo] + w * trajs[:, lo + 1]).astype(trajs.dtype)


def expand_future_trajs(gt_fut_trajs: np.ndarray, M: int | None = None):
    """Per-agent deltas (K, 6, 2), row 0 the ego → (ego_traj (T, 2)
    cumulative, obj_trajs (K-1, T, 2))."""
    trajs = np.insert(gt_fut_trajs, 0, 0, axis=1)
    acc = np.cumsum(trajs, axis=1)
    if M is not None:
        acc = interp_trajs(acc, M=M)
    deltas = acc[:, 1:] - acc[:, :-1]
    ego = np.cumsum(deltas[0], axis=0)  # (T, 2)
    obj = np.cumsum(deltas[1:], axis=1)  # (K-1, T, 2)
    return ego, obj


def compute_inter_frame_transforms(future_xy: np.ndarray, z0: float = 0.0) -> np.ndarray:
    """Homogeneous LiDAR_i → LiDAR_{i+1} transforms (T, 4, 4), float64."""
    future_xy = np.asarray(future_xy, np.float64)
    T1 = future_xy.shape[0]
    offsets = np.vstack([future_xy[:1], future_xy[1:] - future_xy[:-1]])
    yaws = np.arctan2(offsets[:, 1], offsets[:, 0]) - np.pi / 2
    yaws[np.linalg.norm(offsets, axis=1) < 0.1] = 0.0
    poses = [np.eye(4)]
    for i in range(T1):
        c, s = np.cos(yaws[i]), np.sin(yaws[i])
        P = np.eye(4)
        P[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        P[:3, 3] = [future_xy[i, 0], future_xy[i, 1], z0]
        poses.append(P)
    return np.stack([np.linalg.inv(poses[i + 1]) @ poses[i] for i in range(T1)])


def _norm2(xy: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1])


def _offsets(xy: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Step offsets along the time dim (-2) of (..., T, 2), ``first`` first."""
    return torch.cat([first, xy[..., 1:, :] - xy[..., :-1, :]], dim=-2)


def ego_yaws(future_xy: torch.Tensor, thresh: float = 1e-1) -> torch.Tensor:
    """(..., T, 2) ego positions → (..., T) headings, atan2(dy, dx) − π/2,
    snapped to 0 where the step is shorter than ``thresh``."""
    offsets = _offsets(future_xy, future_xy[..., :1, :])
    yaw = torch.atan2(offsets[..., 1], offsets[..., 0]) - math.pi / 2
    return torch.where(_norm2(offsets) < thresh, 0.0, yaw)


# ----------------------------------------------------------------- warping


def warp_lidar_future(P: torch.Tensor, future_xy: torch.Tensor, z0: float = 0.0) -> torch.Tensor:
    """Current-frame cloud (M, 4) → each future LiDAR frame (T, M, 4)."""
    yaws = ego_yaws(future_xy)[:, None]
    c, s = torch.cos(yaws), torch.sin(yaws)
    tx = P[None, :, 0] - future_xy[:, 0:1]
    ty = P[None, :, 1] - future_xy[:, 1:2]
    tz = (P[:, 2] - z0).expand(tx.shape)
    # (xyz − [x, y, z0]) @ [[c, −s, 0], [s, c, 0], [0, 0, 1]]
    xyz = torch.stack([tx * c + ty * s, ty * c - tx * s, tz], dim=-1)
    return torch.cat([xyz, P[None, :, 3:4].expand(xyz.shape[0], -1, -1)], dim=-1)


def warp_boxes_future(
    boxes0: torch.Tensor,
    traj_obj: torch.Tensor,
    traj_ego: torch.Tensor,
    z_e: float = 0.0,
) -> torch.Tensor:
    """Each object's box in each future LiDAR frame: ``boxes0`` (..., K, 7),
    ``traj_obj`` (..., K, T, 2), ``traj_ego`` (..., T, 2) → (..., K, T, 7).

    An object's heading follows its step direction and keeps its last value
    while it stands still (a step under 1e-3); step 0 keeps ``boxes0``'s.
    """
    T = traj_obj.shape[-2]
    yaw_ego = ego_yaws(traj_ego)[..., None, :]  # (..., 1, T)
    obj_offsets = _offsets(traj_obj, torch.zeros_like(traj_obj[..., :1, :]))
    step_yaw = torch.atan2(obj_offsets[..., 1], obj_offsets[..., 0])  # (..., K, T)
    moving = _norm2(obj_offsets) >= 1e-3
    # the yaw of step t is that of the last moving step ≤ t (step 0: boxes0's)
    yaws = torch.cat([boxes0[..., 6:7], step_yaw[..., 1:]], dim=-1)
    steps = torch.arange(T, device=traj_obj.device)
    last = torch.cummax(torch.where(moving, steps, 0), dim=-1).values
    yaw_obj = torch.gather(yaws, -1, last)

    c_e, s_e = torch.cos(yaw_ego), torch.sin(yaw_ego)
    tx = (boxes0[..., 0:1] + traj_obj[..., 0]) - traj_ego[..., None, :, 0]
    ty = (boxes0[..., 1:2] + traj_obj[..., 1]) - traj_ego[..., None, :, 1]
    tz = (boxes0[..., 2:3] - z_e).expand(tx.shape)
    # [[c, s, 0], [−s, c, 0], [0, 0, 1]] @ (C_world − [ego_x, ego_y, z_e])
    centre = torch.stack([c_e * tx + s_e * ty, c_e * ty - s_e * tx, tz], dim=-1)
    size = boxes0[..., None, 3:6].expand(*centre.shape[:-1], 3)
    return torch.cat([centre, size, (yaw_obj - yaw_ego)[..., None]], dim=-1)


# ----------------------------------------------------------------- point ops


def first_member_indices(member: torch.Tensor, take: int) -> torch.Tensor:
    """(..., N) bool → (..., take) indices: the members in point order, then
    the non-members in point order (one stable argsort)."""
    N = member.shape[-1]
    idx = torch.arange(N, device=member.device)
    return torch.argsort(torch.where(member, idx, N), dim=-1, stable=True)[..., :take]


def split_foreground_background(
    points: torch.Tensor,
    point_mask: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
    max_points_per_obj: int = 512,
):
    """Split padded clouds into background and per-object points in the
    object's box frame (centred at the box, de-rotated by its yaw).

    Each object keeps its first ``max_points_per_obj`` (P) member points in
    point order, zero-padded.  Returns ``(bg_mask (S, N), obj_points
    (S, K, P, 4), obj_point_mask (S, K, P))``.
    """
    S, N, C = points.shape
    K = boxes.shape[1]
    P = max_points_per_obj
    member = points_in_boxes(points[..., :3], boxes) & point_mask[:, None, :] & box_mask[:, :, None]
    bg_mask = point_mask & ~member.any(dim=1)

    take = min(P, N)
    src = first_member_indices(member, take)  # (S, K, take)
    msk = torch.gather(member, 2, src)
    buf = torch.gather(points[:, None].expand(S, K, N, C), 2, src[..., None].expand(S, K, take, C))
    buf = torch.where(msk[..., None], buf, 0.0)
    if take < P:  # N < P: keep the (S, K, P, 4) contract
        buf = torch.nn.functional.pad(buf, (0, 0, 0, P - take))
        msk = torch.nn.functional.pad(msk, (0, P - take))
    centered = torch.cat([buf[..., :3] - boxes[:, :, None, :3], buf[..., 3:]], dim=-1)
    aligned = rotate_points_along_z(centered, -boxes[..., 6])
    return bg_mask, torch.where(msk[..., None], aligned, 0.0), msk


def replay_objects(
    obj_points: torch.Tensor,
    obj_point_mask: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
):
    """Place box-frame object points (S, K, P, 4) at ``boxes`` (S, K, 7):
    rotate by the yaw, move to the centre.  Returns ((S, K, P, 4), (S, K, P))."""
    rot = rotate_points_along_z(obj_points, boxes[..., 6])
    placed = torch.cat([rot[..., :3] + boxes[:, :, None, :3], rot[..., 3:]], dim=-1)
    return placed, obj_point_mask & box_mask[..., None]


def transform_points_homogeneous(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply (S, 4, 4) transforms to (S, N, 4) ``[xyz, intensity]``, as
    multiply-adds in the matrix product's order (no TF32 can reach them)."""
    T = T.to(points.dtype)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def row(i):
        t = T[:, i, :, None]  # (S, 4, 1)
        return t[:, 0] * x + t[:, 1] * y + t[:, 2] * z + t[:, 3]

    return torch.stack([row(0), row(1), row(2), points[..., 3]], dim=-1)


def delete_fg_points_mask(
    points: torch.Tensor,
    point_mask: torch.Tensor,
    boxes: torch.Tensor,
    box_mask: torch.Tensor,
) -> torch.Tensor:
    """``point_mask`` without the points inside any real box."""
    member = points_in_boxes(points[..., :3], boxes) & box_mask[..., None]
    return point_mask & ~member.any(dim=-2)


def refine_points_via_condition_mask(
    points: torch.Tensor,
    point_mask: torch.Tensor,
    boxes_with_class: torch.Tensor,
    box_mask: torch.Tensor,
    H: int = 32,
    W: int = 1024,
    min_depth: float = 1.45,
    max_depth: float = 80.0,
    fov_up: float = 10.0,
    fov_down: float = -30.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hidden-surface and box-interior removal through the range image:
    project the clouds, zero every pixel a box covers (condition mask > 0)
    and take one point per surviving pixel (norm > 1e-2).

    ``boxes_with_class`` (S, K, 8) ``[x y z l w h yaw class]``; returns the
    fixed (S, H·W, 4) clouds and their masks.
    """
    img = points_to_range_image(
        points, point_mask, H=H, W=W, min_depth=min_depth, max_depth=max_depth,
        fov_up=fov_up, fov_down=fov_down,
    )
    img = img * img[..., 5:6]  # zero the pixels whose point is out of range
    _, condition_mask, _ = convert_boxes_to_2d(
        boxes_with_class, box_mask, H=H, W=W, fov_up=fov_up, fov_down=fov_down
    )
    keep = (condition_mask[..., 0] <= 0)[..., None]
    out = torch.cat([img[..., :3] * keep, img[..., 3:4] * keep], dim=-1)
    out = out.reshape(points.shape[0], H * W, 4)
    return out, norm3(out[..., :3]) > 1e-2
