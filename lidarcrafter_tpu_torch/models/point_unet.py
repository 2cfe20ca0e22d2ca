"""Per-object point-cloud denoiser and its box + class condition encoder.

Port of the JAX package's ``models/point_unet.py``: ``PointUNet`` (six
gated linear ``PCNet`` layers over (B, N, point_dim) box-normalised points)
and ``ObjectGenEncoder`` (NeRF-Fourier box embedding + the class's CLIP
text feature → a 768-d condition).  The CLIP features are data: a
(num_class, 512) ``fg_text_features`` table passed in with the boxes.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class PCNet(nn.Module):
    """``fea_layer(fea) · sigmoid(cond_gate(cond)) + cond_bias(cond)``."""

    def __init__(self, dim_in: int, dim_out: int, cond_dim: int):
        super().__init__()
        self.cond_gate = nn.Linear(cond_dim, dim_out)
        self.cond_bias = nn.Linear(cond_dim, dim_out, bias=False)
        self.fea_layer = nn.Linear(dim_in, dim_out)

    def forward(self, fea: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return self.fea_layer(fea) * torch.sigmoid(self.cond_gate(cond)) + self.cond_bias(cond)


class PointUNet(nn.Module):
    """``forward(coords (B, N, D), {'time_condition': (B,),
    'other_condition': (B, F)})``; residual by default."""

    def __init__(self, point_dim: int = 4, cond_dims: int = 768, residual: bool = True):
        super().__init__()
        self.residual = residual
        dims = [point_dim, 128, 256, 512, 256, 128, point_dim]
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}", PCNet(dims[i], dims[i + 1], cond_dims + 3))

    def forward(self, coords: torch.Tensor, cond_dict: dict) -> torch.Tensor:
        B = coords.shape[0]
        beta = cond_dict["time_condition"].reshape(B, 1, 1)
        cond = cond_dict["other_condition"].reshape(B, 1, -1)
        cond_emb = torch.cat([beta, torch.sin(beta), torch.cos(beta), cond], dim=-1)
        out = coords
        for i in range(self.n):
            out = getattr(self, f"layer{i}")(out, cond_emb)
            if i < self.n - 1:
                out = F.leaky_relu(out, negative_slope=0.01)
        return coords + out if self.residual else out


def nerf_fourier_embed(x: torch.Tensor, num_freqs: int, include_input: bool = True) -> torch.Tensor:
    """NeRF positional embedding: ``x``, then sin and cos of x·2^k for k <
    ``num_freqs``."""
    outs = [x] if include_input else []
    for k in range(num_freqs):
        outs += [torch.sin(x * 2.0**k), torch.cos(x * 2.0**k)]
    return torch.cat(outs, dim=-1)


class ObjectGenEncoder(nn.Module):
    """``forward(input_dict)`` with ``fg_encoding_box`` (B, input_dim),
    ``fg_class`` (B,) ints and ``fg_text_features`` (num_class, 512); returns
    the (B, 768) condition."""

    def __init__(
        self,
        num_class: int = 8,
        input_dim: int = 6,
        embedder_num_freq: int = 4,
        class_token_dim: int = 512,
        output_num: int = 1,
        proj_dims: Sequence[int] = (768, 512, 512, 768),
    ):
        super().__init__()
        self.embedder_num_freq = embedder_num_freq
        self.bbox_proj = nn.Linear(input_dim * (1 + 2 * embedder_num_freq), proj_dims[0])
        self.second0 = nn.Linear(proj_dims[0] + class_token_dim, proj_dims[1])
        self.second1 = nn.Linear(proj_dims[1], proj_dims[2])
        self.second2 = nn.Linear(proj_dims[2], proj_dims[3])

    def forward(self, input_dict: dict) -> torch.Tensor:
        classes = input_dict["fg_class"].long()
        table = input_dict["fg_text_features"]
        emb = F.silu(self.bbox_proj(nerf_fourier_embed(input_dict["fg_encoding_box"], self.embedder_num_freq)))
        cls_emb = table[classes.reshape(-1)].reshape(*classes.shape, table.shape[-1])
        emb = F.silu(self.second0(torch.cat([emb, cls_emb], dim=-1)))
        emb = F.silu(self.second1(emb))
        return self.second2(emb)
