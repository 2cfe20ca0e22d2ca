"""The substitute 3D detector (anchor head) behind ``--params`` /
``--random-params`` of the detection CLIs.

Port of the JAX package's ``metrics/models/detector.py``: voxelisation
(first point wins) and submanifold / stride-2 sparse convs
(``ops/sparse.py``) → height compression to a BEV map → a conv BEV backbone
→ an anchor head (class, box, direction) with SECOND's residual box decoding
→ rotated NMS (``ops/iou3d.py``).  Eval mode (frozen BatchNorms).  The
submodules carry the flax names, so a JAX parameter tree loads through
``weights.load_flax_params``; the transposed conv keeps its flax kernel
(kh, kw, in, out).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.iou3d import nms
from ...ops.sparse import voxelize
from ..extractor.pointnet import FrozenBN
from ..extractor.sparse_unet import SparseConvBlock, SubMConv3


class SparseDetBackbone(nn.Module):
    """Stem + 3 stride-2 stages (VoxelBackBone8x's shape); returns the
    deepest level (1/8 resolution)."""

    def __init__(self, in_ch: int, channels: Sequence[int] = (16, 32, 64, 128)):
        super().__init__()
        c = channels
        self.stem, self.stem_bn = SubMConv3(in_ch, c[0]), FrozenBN(c[0])
        for k in range(1, 4):
            setattr(self, f"down{k}", SparseConvBlock(c[k - 1], c[k]))
            setattr(self, f"stage{k}_conv", SubMConv3(c[k], c[k]))
            setattr(self, f"stage{k}_bn", FrozenBN(c[k]))

    def forward(self, feats, coords, mask):
        f = torch.where(mask[:, None], F.relu(self.stem_bn(self.stem(feats, coords, mask))), 0.0)
        cc, mm = coords, mask
        for k in range(1, 4):
            f, cc, mm = getattr(self, f"down{k}")(f, cc, mm)
            g = getattr(self, f"stage{k}_conv")(f, cc, mm)
            f = torch.where(mm[:, None], F.relu(getattr(self, f"stage{k}_bn")(g)), 0.0)
        return f, cc, mm


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1) -> torch.Tensor:
    """NCHW conv with XLA's ``SAME`` padding (the odd pixel of padding on the
    high side, as flax pads a strided conv)."""
    pads = []
    for size, k in zip(x.shape[:1:-1], weight.shape[:1:-1]):  # W then H, as F.pad lists them
        total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), weight, bias, stride)


class _Conv(nn.Module):
    """A flax ``Conv`` (SAME padding) as an NCHW conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride

    def forward(self, x):
        return conv_same(x, self.weight, self.bias, self.stride)


class _ConvTranspose2x(nn.Module):
    """flax ``ConvTranspose(k=2, s=2)`` with its kernel (2, 2, in, out):
    out[2i+a, 2j+b] = x[i, j] · K[1−a, 1−b]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(2, 2, cin, cout))

    def forward(self, x):
        B, _, H, W = x.shape
        u = torch.einsum("bchw,pqco->bohpwq", x, self.kernel.flip(0, 1))
        return u.reshape(B, -1, 2 * H, 2 * W)


class BEVBackbone(nn.Module):
    """Two conv blocks and the second upsampled, concatenated
    (BaseBEVBackbone's shape); NCHW."""

    def __init__(self, in_ch: int, channels: int = 128):
        super().__init__()
        c = channels
        for tag, cin, ch, stride in (("b1", in_ch, c, 1), ("b2", c, 2 * c, 2)):
            for i in range(3):
                setattr(self, f"{tag}_conv{i}", _Conv(cin if i == 0 else ch, ch, 3, stride if i == 0 else 1, False))
                setattr(self, f"{tag}_bn{i}", FrozenBN(ch))
        self.up2, self.up2_bn = _ConvTranspose2x(2 * c, c), FrozenBN(c)

    def forward(self, x):
        def block(h, tag):
            for i in range(3):
                h = F.relu(getattr(self, f"{tag}_bn{i}")(getattr(self, f"{tag}_conv{i}")(h)))
            return h

        b1 = block(x, "b1")
        up2 = F.relu(self.up2_bn(self.up2(block(b1, "b2"))))
        # odd BEV sizes: the 2x transpose overshoots by one row / column
        return torch.cat([b1, up2[:, :, : b1.shape[2], : b1.shape[3]]], 1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """SECOND / pcdet ``ResidualCoder.decode_torch``: (..., 7) deltas ×
    (..., 7) anchors → boxes, z through the box's top as pcdet does."""
    xa, ya, za, la, wa, ha, ra = anchors.unbind(-1)
    diag = torch.sqrt(la**2 + wa**2)
    h = torch.exp(deltas[..., 5]) * ha
    return torch.stack([deltas[..., 0] * diag + xa, deltas[..., 1] * diag + ya,
                        deltas[..., 2] * ha + (za + ha / 2) - h / 2, torch.exp(deltas[..., 3]) * la,
                        torch.exp(deltas[..., 4]) * wa, h, deltas[..., 6] + ra], -1)


class VoxelDetector(nn.Module):
    """Single-cloud anchor detector: ``forward(points (N, 3+), point_mask)``
    → per-anchor decoded ``boxes`` (A, 7), sigmoid ``scores`` (A, classes)
    and ``dir_logits``; :func:`predict` adds the threshold and NMS.
    ``in_dims`` is the points' width (4: x, y, z, remission)."""

    def __init__(self, point_range: Sequence[float] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0), voxel_size: float = 0.3,
                 max_voxels: int = 16384, num_classes: int = 4,
                 anchor_sizes: Sequence[Sequence[float]] = ((4.6, 1.95, 1.72), (6.9, 2.5, 2.8), (11.0, 2.9, 3.5),
                                                            (0.7, 0.7, 1.7)),
                 anchor_rotations: Sequence[float] = (0.0, 1.5707963), in_dims: int = 4):
        super().__init__()
        self.point_range, self.voxel_size, self.max_voxels = tuple(point_range), voxel_size, max_voxels
        self.num_classes, self.anchor_sizes, self.anchor_rotations = num_classes, anchor_sizes, anchor_rotations
        pr = self.point_range
        self.nz = max(int(round((pr[5] - pr[2]) / voxel_size)) // 8, 1)
        self.backbone3d = SparseDetBackbone(in_dims)
        self.backbone2d = BEVBackbone(self.nz * 128)
        A = len(anchor_rotations) * len(anchor_sizes)
        self.cls_head = _Conv(256, A * num_classes, 1)
        self.box_head = _Conv(256, A * 7, 1)
        self.dir_head = _Conv(256, A * 2, 1)

    @property
    def bev_shape(self):
        pr = self.point_range
        nx = int(round((pr[3] - pr[0]) / self.voxel_size))
        ny = int(round((pr[4] - pr[1]) / self.voxel_size))
        return ny // 8, nx // 8

    def anchors(self) -> np.ndarray:
        """(H, W, R·C, 7) anchors at the BEV resolution."""
        Hb, Wb = self.bev_shape
        pr = self.point_range
        ys = pr[1] + (np.arange(Hb) + 0.5) * (pr[4] - pr[1]) / Hb
        xs = pr[0] + (np.arange(Wb) + 0.5) * (pr[3] - pr[0]) / Wb
        out = []
        for rot in self.anchor_rotations:
            for size in self.anchor_sizes:
                a = np.zeros((Hb, Wb, 7), np.float32)
                a[..., 0], a[..., 1], a[..., 2] = xs[None, :], ys[:, None], -1.0
                a[..., 3:6], a[..., 6] = size, rot
                out.append(a)
        return np.stack(out, axis=2).reshape(Hb, Wb, -1, 7)

    def forward(self, points, point_mask):
        pr = points.new_tensor(self.point_range)
        inr = point_mask & (points[:, :3] >= pr[:3]).all(-1) & (points[:, :3] < pr[3:] - 1e-3).all(-1)
        shifted = points[:, :3] - pr[:3]
        coords, src, vmask, _ = voxelize(shifted, self.voxel_size, point_mask=inr, max_voxels=self.max_voxels)
        src = src.long()
        feats = torch.where(vmask[:, None], points[src] if points.shape[1] > 3 else shifted[src], 0.0)
        f, cc, mm = self.backbone3d(feats, coords, vmask)

        # height compression: the deepest level scattered into a dense BEV
        # grid, the z bins concatenated along the channels
        Hb, Wb = self.bev_shape
        nz, C = self.nz, f.shape[-1]
        zi = torch.where(mm, cc[:, 2].clamp(0, nz - 1), nz).long()
        yi, xi = cc[:, 1].clamp(0, Hb - 1).long(), cc[:, 0].clamp(0, Wb - 1).long()
        dense = f.new_zeros(nz + 1, Hb, Wb, C).index_put_((zi, yi, xi), torch.where(mm[:, None], f, 0.0),
                                                           accumulate=True)[:nz]
        bev = dense.permute(1, 2, 0, 3).reshape(Hb, Wb, nz * C).permute(2, 0, 1)[None]  # channel z·C + c

        h = self.backbone2d(bev)
        A = len(self.anchor_rotations) * len(self.anchor_sizes)
        cls, box, dirc = (head(h)[0].permute(1, 2, 0) for head in (self.cls_head, self.box_head, self.dir_head))
        anchors = torch.as_tensor(self.anchors(), device=points.device)
        boxes = decode_boxes(box.reshape(Hb, Wb, A, 7), anchors)
        return {"boxes": boxes.reshape(-1, 7), "scores": torch.sigmoid(cls.reshape(-1, self.num_classes)),
                "dir_logits": dirc.reshape(-1, 2)}


@torch.inference_mode()
def predict(model: VoxelDetector, points, point_mask, score_thresh: float = 0.3, nms_thresh: float = 0.2,
            max_dets: int = 128):
    """Single-cloud detection: forward → the top scores → direction flip →
    rotated BEV NMS → (boxes (K, 7), scores (K,), labels (K,), valid (K,))."""
    out = model(points, point_mask)
    scores = out["scores"]
    best, labels = scores.max(-1).values, torch.argmax(scores, -1)
    boxes = out["boxes"].clone()
    boxes[:, 6] = boxes[:, 6] + torch.argmax(out["dir_logits"], -1) * np.pi
    k = min(max_dets * 4, boxes.shape[0])
    top, idx = torch.sort(best, descending=True, stable=True)  # top_k's order: ties to the lower index
    top, idx = top[:k], idx[:k]
    cand_boxes, cand_labels = boxes[idx], labels[idx]
    order, keep = nms(cand_boxes, top, nms_thresh, box_mask=top >= score_thresh)
    order, keep = order[:max_dets], keep[:max_dets]
    return cand_boxes[order], top[order], cand_labels[order], keep
