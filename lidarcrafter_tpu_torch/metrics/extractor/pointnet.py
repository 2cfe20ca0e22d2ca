"""Frozen ShapeNet PointNet feature extractor (the FPD backbone).

Port of the JAX package's ``metrics/extractor/pointnet.py``: the STN3d input
transform, the PointNet trunk and the FC head; the FPD feature is the
concat (x1, x2, x3, x4) of the trunk's global feature and the head's
activations, (B, N, 3) → (B, 1024 + 512 + 256 + k).  Inference only: the
BatchNorms run on their running statistics.  The submodules carry the flax
names, so the JAX parameter tree loads through ``weights.load_flax_params``,
and :func:`convert_pointnet_state_dict` reads upstream's torch weights
(``cls_model_39.pth``).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """BatchNorm in eval mode: over dim 1 of an NCHW map, over the last dim
    otherwise.  ``weight`` / ``bias`` are the flax ``scale`` / ``bias``, the
    buffers ``running_mean`` / ``running_var`` its ``mean`` / ``var``.  The
    statistics take gradients where they require them
    (``training/segmentation.py::train_frozen_statistics_``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            if not self.running_mean.requires_grad:
                return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0,
                                    self.eps)
            # trained statistics (the RangeNet trainer): written out, since
            # batch_norm passes no gradient to them
            stats = [t[:, None, None] for t in (self.running_mean, self.running_var, self.weight, self.bias)]
            mean, var, weight, bias = stats
            return (x - mean) / torch.sqrt(var + self.eps) * weight + bias
        return (x - self.running_mean) / torch.sqrt(self.running_var + self.eps) * self.weight + self.bias


class MLPBlock(nn.Module):
    def __init__(self, in_features: int, features: int, relu: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, features)
        self.bn = FrozenBN(features)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.dense(x))
        return F.relu(x) if self.relu else x


class STN3d(nn.Module):
    """Input-transform net; x: (B, N, 3) → (B, 3, 3)."""

    def __init__(self):
        super().__init__()
        self.conv1 = MLPBlock(3, 64)
        self.conv2 = MLPBlock(64, 128)
        self.conv3 = MLPBlock(128, 1024)
        self.fc1 = MLPBlock(1024, 512)
        self.fc2 = MLPBlock(512, 256)
        self.fc3 = nn.Linear(256, 9)

    def forward(self, x):
        h = self.conv3(self.conv2(self.conv1(x))).amax(dim=1)
        h = self.fc3(self.fc2(self.fc1(h))).reshape(-1, 3, 3)
        return h + torch.eye(3, dtype=h.dtype, device=h.device)


class PointNetFeatureExtractor(nn.Module):
    """Upstream's ``PointNet1``; x (B, N, 3) → (B, 1792 + k)."""

    def __init__(self, k: int = 16):
        super().__init__()
        self.stn = STN3d()
        self.feat_conv1 = MLPBlock(3, 64)
        self.feat_conv2 = MLPBlock(64, 128)
        self.feat_conv3 = MLPBlock(128, 1024, relu=False)
        self.fc1 = MLPBlock(1024, 512)
        self.fc2 = MLPBlock(512, 256)
        self.fc3 = nn.Linear(256, k)

    def forward(self, x):
        x = torch.bmm(x, self.stn(x))
        x1 = self.feat_conv3(self.feat_conv2(self.feat_conv1(x))).amax(dim=1)  # (B, 1024)
        x2 = self.fc1(x1)
        x3 = self.fc2(x2)
        return torch.cat([x1, x2, x3, self.fc3(x3)], dim=1)


def convert_pointnet_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """Upstream's torch ``PointNet1`` state_dict → the ``state_dict`` of
    :class:`PointNetFeatureExtractor` (Conv1d (O, I, 1) → Linear (O, I))."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out = {}

    def block(name, prefix_w, prefix_bn, conv=True):
        w = sd[f"{prefix_w}.weight"]
        out[f"{name}.dense.weight"] = w[..., 0] if conv else w
        out[f"{name}.dense.bias"] = sd[f"{prefix_w}.bias"]
        for stat in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.bn.{stat}"] = sd[f"{prefix_bn}.{stat}"]

    def dense(name, prefix):
        out[f"{name}.weight"] = sd[f"{prefix}.weight"]
        out[f"{name}.bias"] = sd[f"{prefix}.bias"]

    for i in (1, 2, 3):
        block(f"stn.conv{i}", f"feat.stn.conv{i}", f"feat.stn.bn{i}")
    block("stn.fc1", "feat.stn.fc1", "feat.stn.bn4", conv=False)
    block("stn.fc2", "feat.stn.fc2", "feat.stn.bn5", conv=False)
    dense("stn.fc3", "feat.stn.fc3")
    for i in (1, 2, 3):
        block(f"feat_conv{i}", f"feat.conv{i}", f"feat.bn{i}")
    block("fc1", "fc1", "bn1", conv=False)
    block("fc2", "fc2", "bn2", conv=False)
    dense("fc3", "fc3")
    return {k: v.float().contiguous() for k, v in out.items()}
