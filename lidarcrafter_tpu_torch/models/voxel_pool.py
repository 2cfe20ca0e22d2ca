"""Voxel-neighbourhood set-abstraction pooling (Voxel R-CNN's RoI pooling).

Port of the JAX package's ``models/voxel_pool.py`` (upstream's
``NeighborVoxelSAModuleMSG``): per scale a voxel-window ball query
(``ops/stack.py::voxel_query``), a channel MLP on the grouped features plus
a position MLP on their offsets, ReLU, a max or mean over the neighbours and
an output MLP; the scales concatenate.  BatchNorms frozen.  The submodules
carry the flax names (``mlp_in{k}``, ``mlp_in{k}_bn``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.extractor.pointnet import FrozenBN
from ..ops.stack import voxel_query


class NeighborVoxelSAPool(nn.Module):
    """``forward(xyz (N, 3), new_xyz (M, 3), new_coords (M, 4) [b, x, y, z],
    features (N, C), point_indices (B, Z, Y, X), new_mask)`` → (M,
    Σ mlps[k][2]); ``mlps[k]`` is (in, mid, out)."""

    def __init__(self, query_ranges: Sequence[Sequence[int]], radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], pool_method: str = "max_pool"):
        super().__init__()
        if pool_method not in ("max_pool", "avg_pool"):
            raise NotImplementedError(pool_method)
        self.query_ranges, self.radii, self.nsamples = query_ranges, radii, nsamples
        self.pool_method = pool_method
        for k, (cin, mid, out) in enumerate(mlps):
            setattr(self, f"mlp_in{k}", nn.Linear(cin, mid, bias=False))
            setattr(self, f"mlp_in{k}_bn", FrozenBN(mid))
            setattr(self, f"mlp_pos{k}", nn.Linear(3, mid, bias=False))
            setattr(self, f"mlp_pos{k}_bn", FrozenBN(mid))
            setattr(self, f"mlp_out{k}", nn.Linear(mid, out, bias=False))
            setattr(self, f"mlp_out{k}_bn", FrozenBN(out))

    def forward(self, xyz, new_xyz, new_coords, features, point_indices, new_mask=None):
        if new_mask is None:
            new_mask = torch.ones(new_xyz.shape[0], dtype=torch.bool, device=new_xyz.device)
        new_coords_bzyx = new_coords[:, [0, 3, 2, 1]]
        outs = []
        for k in range(len(self.query_ranges)):
            f_in = getattr(self, f"mlp_in{k}_bn")(getattr(self, f"mlp_in{k}")(features))
            idx, empty = voxel_query(new_coords_bzyx, new_xyz, xyz, point_indices,
                                     query_range=tuple(self.query_ranges[k]), radius=float(self.radii[k]),
                                     nsample=int(self.nsamples[k]), new_mask=new_mask)
            keep = (~empty & new_mask)[:, None, None]
            idx = idx.long()
            grouped = torch.where(keep, f_in[idx], 0.0)
            gxyz = torch.where(keep, xyz[idx] - new_xyz[:, None, :], 0.0)
            h = F.relu(grouped + getattr(self, f"mlp_pos{k}_bn")(getattr(self, f"mlp_pos{k}")(gxyz)))
            h = h.amax(1) if self.pool_method == "max_pool" else h.mean(1)
            h = F.relu(getattr(self, f"mlp_out{k}_bn")(getattr(self, f"mlp_out{k}")(h)))
            outs.append(torch.where(new_mask[:, None], h, 0.0))
        return torch.cat(outs, -1)
