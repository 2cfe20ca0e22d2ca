"""PointMLP point-cloud classifier: the CGF backbone and the model of the
PointMLP trainer.

Port of the JAX package's ``metrics/extractor/pointmlp.py``: geometric
affine local grouping (farthest point sampling and k nearest neighbours from
``ops/points.py``), residual MLPs per group, max pooling, and the BatchNorm
classifier head.  Points are (B, N, 3) and features (B, N, C), channels
last, as in the JAX package.  ``forward(x, train=...)``: ``train`` runs the
BatchNorms on batch statistics (updating their running averages as flax
does, ``models/batch_norm.py``) and the head's dropout; otherwise the
running statistics, no dropout.

The submodules carry the flax names, so a flax variable dict loads through
``weights.load_flax_params``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...models.batch_norm import BatchNorm
from ...ops.points import farthest_point_sampling, knn


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each value with probability ``1 − rate``
    and scale the kept ones by ``1 / (1 − rate)``; the draw comes from
    ``generator`` (on ``x``'s device)."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows at the (B, ...) indices → (B, ..., C)."""
    B = x.shape[0]
    batch = torch.arange(B, device=x.device).reshape(B, *([1] * (idx.ndim - 1)))
    return x[batch, idx.long()]


class ConvBNReLU(nn.Module):
    """Linear + BN + ReLU over the last axis."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False):
        super().__init__()
        self.dense = nn.Linear(in_features, features, bias=use_bias)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.bn(self.dense(x), train))


class ConvBNReLURes(nn.Module):
    """Residual MLP block."""

    def __init__(self, channel: int, res_expansion: float = 1.0, use_bias: bool = False):
        super().__init__()
        mid = int(channel * res_expansion)
        self.net1 = ConvBNReLU(channel, mid, use_bias)
        self.net2_dense = nn.Linear(mid, channel, bias=use_bias)
        self.net2_bn = BatchNorm(channel)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.net2_bn(self.net2_dense(self.net1(x, train)), train)
        return F.relu(h + x)


class LocalGrouper(nn.Module):
    """FPS + kNN grouping with the geometric affine: ``groups`` centres,
    ``kneighbors`` neighbours each (at most N), normalised by the centre
    (``'anchor'``) or the group mean (``'center'``) and the std of each
    sample's whole grouped tensor (Bessel-corrected, as ``torch.std``)."""

    def __init__(self, channel: int, groups: int, kneighbors: int, use_xyz: bool = False,
                 normalize: str = "anchor"):
        super().__init__()
        self.groups, self.kneighbors, self.use_xyz, self.normalize = groups, kneighbors, use_xyz, normalize
        if normalize in ("center", "anchor"):
            d = channel + 3 if use_xyz else channel
            self.affine_alpha = nn.Parameter(torch.ones(1, 1, 1, d))
            self.affine_beta = nn.Parameter(torch.zeros(1, 1, 1, d))

    def forward(self, xyz: torch.Tensor, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        B, N, _ = xyz.shape
        fps_idx = farthest_point_sampling(xyz, self.groups)  # (B, S)
        new_xyz, new_points = take_rows(xyz, fps_idx), take_rows(points, fps_idx)
        k = min(self.kneighbors, N)  # small test clouds: at most the points there are
        _, idx = knn(new_xyz, xyz, k)  # (B, S, k)
        grouped_xyz, grouped_points = take_rows(xyz, idx), take_rows(points, idx)
        if self.use_xyz:
            grouped_points = torch.cat([grouped_points, grouped_xyz], dim=-1)
        if self.normalize in ("center", "anchor"):
            if self.normalize == "center":
                mean = grouped_points.mean(dim=2, keepdim=True)
            else:
                anchor = torch.cat([new_points, new_xyz], dim=-1) if self.use_xyz else new_points
                mean = anchor[:, :, None, :]
            centered = grouped_points - mean
            flat = centered.reshape(B, -1)
            n = flat.shape[1]
            std = torch.sqrt(((flat - flat.mean(dim=1, keepdim=True)) ** 2).sum(dim=1) / (n - 1))
            grouped_points = centered / (std[:, None, None, None] + 1e-5)
            grouped_points = self.affine_alpha * grouped_points + self.affine_beta
        rep = new_points[:, :, None, :].expand(-1, -1, k, -1)
        return new_xyz, torch.cat([grouped_points, rep], dim=-1)


class PreExtraction(nn.Module):
    """Per-group MLPs and a max over the neighbours: (B, S, k, d) → (B, S, C)."""

    def __init__(self, in_channels: int, out_channels: int, blocks: int = 2, res_expansion: float = 1.0,
                 use_bias: bool = False):
        super().__init__()
        self.out_channels, self.blocks = out_channels, blocks
        self.transfer = ConvBNReLU(in_channels, out_channels, use_bias)
        for i in range(blocks):
            setattr(self, f"op{i}", ConvBNReLURes(out_channels, res_expansion, use_bias))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, S, k, d = x.shape
        h = self.transfer(x.reshape(B * S, k, d), train)
        for i in range(self.blocks):
            h = getattr(self, f"op{i}")(h, train)
        return h.amax(dim=1).reshape(B, S, self.out_channels)


class PointMLP(nn.Module):
    """``forward(x (B, N, 3), train=False, return_features=False,
    generator=None)`` → (B, class_num) logits, or the (B, C) pooled feature
    with ``return_features``; ``generator`` draws the head's dropout."""

    def __init__(
        self,
        points: int = 1024,
        class_num: int = 40,
        embed_dim: int = 64,
        res_expansion: float = 1.0,
        use_bias: bool = False,
        use_xyz: bool = False,
        normalize: str = "anchor",
        dim_expansion: Sequence[int] = (2, 2, 2, 2),
        pre_blocks: Sequence[int] = (2, 2, 2, 2),
        pos_blocks: Sequence[int] = (2, 2, 2, 2),
        k_neighbors: Sequence[int] = (24, 24, 24, 24),
        reducers: Sequence[int] = (2, 2, 2, 2),
        dropout: float = 0.5,
    ):
        super().__init__()
        self.num_stages, self.pos_blocks, self.dropout_rate = len(pre_blocks), tuple(pos_blocks), dropout
        self.embedding = ConvBNReLU(3, embed_dim, use_bias)
        last, anchor = embed_dim, points
        for i in range(self.num_stages):
            out_ch = last * dim_expansion[i]
            anchor = anchor // reducers[i]
            setattr(self, f"grouper{i}", LocalGrouper(last, anchor, k_neighbors[i], use_xyz, normalize))
            grouped = (last + 3 if use_xyz else last) + last
            setattr(self, f"pre{i}", PreExtraction(grouped, out_ch, pre_blocks[i], res_expansion, use_bias))
            for j in range(pos_blocks[i]):
                setattr(self, f"pos{i}_{j}", ConvBNReLURes(out_ch, res_expansion, use_bias))
            last = out_ch
        self.feature_dim = last
        self.cls0, self.cls_bn0 = nn.Linear(last, 512), BatchNorm(512)
        self.cls1, self.cls_bn1 = nn.Linear(512, 256), BatchNorm(256)
        self.cls2 = nn.Linear(256, class_num)

    def forward(self, x: torch.Tensor, train: bool = False, return_features: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        xyz = x
        h = self.embedding(x, train)
        for i in range(self.num_stages):
            xyz, grouped = getattr(self, f"grouper{i}")(xyz, h)
            h = getattr(self, f"pre{i}")(grouped, train)
            for j in range(self.pos_blocks[i]):
                h = getattr(self, f"pos{i}_{j}")(h, train)
        feat = h.amax(dim=1)
        if return_features:
            return feat
        rate = self.dropout_rate if train else 0.0
        h = dropout(F.relu(self.cls_bn0(self.cls0(feat), train)), rate, generator)
        h = dropout(F.relu(self.cls_bn1(self.cls1(h), train)), rate, generator)
        return self.cls2(h)


def point_mlp(num_classes: int = 40, **kwargs) -> PointMLP:
    """The PointMLP factory."""
    return PointMLP(class_num=num_classes, **kwargs)


def point_mlp_elite(num_classes: int = 40, **kwargs) -> PointMLP:
    """The PointMLP-elite factory."""
    return PointMLP(class_num=num_classes, embed_dim=32, res_expansion=0.25, dim_expansion=(2, 2, 2, 1),
                    pre_blocks=(1, 1, 2, 1), pos_blocks=(1, 1, 2, 1), **kwargs)


def load_pointmlp(path, device: str | torch.device = "cpu") -> PointMLP:
    """The PointMLP of a ``train_pointmlp`` checkpoint directory (its
    ``config.json`` holds ``num_classes`` and ``points``), in eval mode on
    ``device``."""
    import json
    from pathlib import Path

    from ...training.checkpoint import load_weights

    cfg = json.loads((Path(path) / "config.json").read_text())
    model = point_mlp(num_classes=cfg["num_classes"], points=cfg["points"])
    load_weights(path, {"model": model}, ema=False)
    return model.to(device).eval()
