"""Sequence-level metrics: TTCE (ICP ego-motion error) and TCD (temporal
chamfer distance).

Port of the JAX package's ``metrics/temporal.py``: point-to-point ICP with
a fixed 30 iterations (chunked nearest neighbours, then a weighted
Procrustes step through a 3×3 SVD), all on the clouds' device; the
ground-truth transform from the calibration chain is host float64, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chamfer import chamfer_distance, nn_chunked


def icp_point_to_point(
    src: torch.Tensor,
    tgt: torch.Tensor,
    src_mask: torch.Tensor | None = None,
    tgt_mask: torch.Tensor | None = None,
    threshold: float = 2.0,
    iters: int = 30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Point-to-point ICP of (N, 3) ``src`` onto (M, 3) ``tgt`` (Open3D's
    ``registration_icp``: identity start, correspondences within
    ``threshold``).  Returns (R (3, 3), t (3,)) mapping src → tgt."""
    if src_mask is None:
        src_mask = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    R = torch.eye(3, dtype=src.dtype, device=src.device)
    t = src.new_zeros(3)
    D = torch.eye(3, dtype=src.dtype, device=src.device)
    for _ in range(iters):
        moved = src @ R.T + t
        d2, idx = nn_chunked(moved[None], tgt[None], None if tgt_mask is None else tgt_mask[None])
        w = (src_mask & (d2[0] < threshold * threshold)).to(src.dtype)[:, None]
        wsum = w.sum().clamp(min=1.0)
        corr = tgt[idx[0]]
        mu_s = (moved * w).sum(0) / wsum
        mu_t = (corr * w).sum(0) / wsum
        H = ((moved - mu_s) * w).T @ (corr - mu_t)
        U, _, Vt = torch.linalg.svd(H)
        D[2, 2] = torch.sign(torch.linalg.det(Vt.T @ U.T))  # no reflection
        R_step = Vt.T @ D @ U.T
        t_step = mu_t - R_step @ mu_s
        R, t = R_step @ R, R_step @ t + t_step
    return R, t


def relative_gt_transform(source_info: dict, target_info: dict):
    """Ground-truth lidar-frame transform between two frames from their
    calibration chains (host float64).

    ``*_info``: dicts with lidar2ego_{rotation,translation} (rotation as a
    3x3 matrix or a wxyz quaternion) and ego2global_{rotation,translation}.
    Returns (R, T) with points_target ≈ points_source @ R + T.
    """

    def rotmat(q):
        q = np.asarray(q, np.float64)
        if q.shape == (3, 3):
            return q
        w, x, y, z = q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )

    l2e_r_s_mat = rotmat(source_info["lidar2ego_rotation"])
    e2g_r_s_mat = rotmat(source_info["ego2global_rotation"])
    l2e_t_s = np.asarray(source_info["lidar2ego_translation"], np.float64)
    e2g_t_s = np.asarray(source_info["ego2global_translation"], np.float64)
    e2g_r_mat = rotmat(target_info["ego2global_rotation"])
    l2e_r_mat = rotmat(target_info["lidar2ego_rotation"])
    e2g_t = np.asarray(target_info["ego2global_translation"], np.float64)
    l2e_t = np.asarray(target_info["lidar2ego_translation"], np.float64)

    inv = np.linalg.inv
    R = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ (inv(e2g_r_mat).T @ inv(l2e_r_mat).T)
    T = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ (inv(e2g_r_mat).T @ inv(l2e_r_mat).T)
    T -= e2g_t @ (inv(e2g_r_mat).T @ inv(l2e_r_mat).T) + l2e_t @ inv(l2e_r_mat).T
    return R.T, T


def ttce_error(t_est: np.ndarray, t_gt: np.ndarray) -> float:
    """Mean absolute translation error."""
    return float(np.mean(np.abs(np.asarray(t_est) - np.asarray(t_gt))))


def _frames(frames, device) -> list[torch.Tensor]:
    return [torch.as_tensor(np.asarray(f, np.float32), device=device) for f in frames]


def sequence_ttce(frames, infos, splits=(3, 4), threshold: float = 2.0,
                  device: str | torch.device = "cuda") -> dict:
    """TTCE of one sequence: ICP between the (N_i, 3) lidar-frame clouds
    ``split`` frames apart against the calibration ``infos``' ground truth;
    {split: [errors]}."""
    clouds = _frames(frames, device)
    out = {s: [] for s in splits}
    for split in splits:
        for i in range(len(frames) - split):
            _, t_est = icp_point_to_point(clouds[i], clouds[i + split], threshold=threshold)
            _, t_gt = relative_gt_transform(infos[i], infos[i + split])
            out[split].append(ttce_error(t_est.cpu().numpy(), t_gt))
    return out


def sequence_tcd(global_frames, splits=(1, 2, 3, 4), device: str | torch.device = "cuda") -> dict:
    """TCD of one sequence: the symmetric chamfer between global-frame
    clouds ``split`` frames apart; {split: [distances]}."""
    clouds = _frames(global_frames, device)
    out = {}
    for split in splits:
        vals = []
        for i in range(len(clouds) - split):
            d1, d2, _, _ = chamfer_distance(clouds[i][None], clouds[i + split][None])
            vals.append((d1.mean() + d2.mean()) / 2)
        out[split] = torch.stack(vals).tolist() if vals else []
    return out
