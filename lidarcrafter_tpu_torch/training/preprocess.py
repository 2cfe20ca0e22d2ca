"""Condition pre-processing and sample post-processing on NHWC tensors.

Port of the JAX package's ``training/preprocess.py``: depth codec + [-1, 1]
normalization of the denoised channels, one-hot semantic + normalized depth
for the concat condition, normalized previous-frame depth for the
autoregressive condition, and [-1, 1] sample → depth / xyz / reflectance.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.lidar import LiDARUtility


def preprocess_x0(
    batch: dict,
    lidar_utils: LiDARUtility,
    train_depth: bool = True,
    train_reflectance: bool = True,
) -> torch.Tensor:
    """depth / reflectance (B,H,W,1) each → normalized x_0 (B,H,W,C)."""
    x = []
    if train_depth:
        x.append(lidar_utils.convert_depth(batch["depth"]))
    if train_reflectance:
        x.append(batch["reflectance"])
    return lidar_utils.normalize(torch.cat(x, dim=-1))


def preprocess_condition_mask(
    batch: dict, lidar_utils: LiDARUtility, num_classes: int = 8
) -> torch.Tensor:
    """condition_mask (B,H,W,2) [semantic, depth] → (B,H,W,num_classes+2)."""
    cm = batch["condition_mask"]
    labels = cm[..., 0].to(torch.int64)
    # out-of-range labels give an all-zero row, as jax.nn.one_hot does; a
    # comparison, since F.one_hot reads its indices back to check them
    classes = torch.arange(num_classes + 1, device=cm.device)
    one_hot = (labels[..., None] == classes).to(cm.dtype)
    depth = lidar_utils.convert_depth(cm[..., 1:2])
    return torch.cat([one_hot, depth], dim=-1)


def preprocess_autoregressive_cond(
    cond: torch.Tensor,
    lidar_utils: LiDARUtility,
    include_reflectance: bool = False,
) -> torch.Tensor:
    """(B,H,W,2) [depth, reflectance] → normalized condition channels."""
    x = [lidar_utils.convert_depth(cond[..., 0:1])]
    if include_reflectance:
        x.append(cond[..., 1:2])
    return lidar_utils.normalize(torch.cat(x, dim=-1))


def postprocess_sample(sample: torch.Tensor, lidar_utils: LiDARUtility) -> dict:
    """Generated [-1,1] image → metric depth, xyz, reflectance."""
    img = lidar_utils.denormalize(sample)
    depth = lidar_utils.revert_depth(img[..., 0:1])
    out = {"depth": depth, "xyz": lidar_utils.to_xyz(depth)}
    if sample.shape[-1] > 1:
        out["reflectance"] = img[..., 1:2]
    return out
