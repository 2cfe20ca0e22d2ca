"""LiDARGen's RefineNet / NCSN backbone (registry key ``refinenet``), NHWC.

Port of the JAX package's ``models/refinenet.py``: convolutions padded
circularly on both spatial axes, the conditioning-free
``InstanceNormPlus``, a dilated residual encoder and a RefineNet decoder
(residual conv units, chained residual pooling, align-corners bilinear
upsampling).  Plain PyTorch: the JAX package computes it in XLA, so cuDNN
runs the convolutions and no kernel of the port is involved.

Submodules carry the JAX package's names, so a flax parameter path maps
onto a ``state_dict`` key one to one (``weights.py``); the flax auto-name
``Conv_0`` inside each ``CircularConv`` is ``conv_0``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .easy_unet import bilinear_resize_align_corners
from .ops import to_nchw, to_nhwc


class CircularConv(nn.Module):
    """A square conv whose input is padded circularly on both H and W (as
    PyTorch's ``padding_mode='circular'``), with dilation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, padding: int = 1,
                 dilation: int = 1, use_bias: bool = True):
        super().__init__()
        self.padding = padding
        self.conv_0 = nn.Conv2d(in_channels, features, kernel_size, dilation=dilation, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = to_nchw(x)
        p = self.padding
        if p > 0:
            h = F.pad(h, (p, p, p, p), mode="circular")
        return to_nhwc(self.conv_0(h))


class InstanceNormPlus(nn.Module):
    """Instance norm scaled by ``alpha`` and by the image's per-channel
    means normalised across channels (their variance with ``ddof=1``), then
    a per-channel affine ``post_weight`` / ``post_bias``."""

    def __init__(self, channels: int, use_bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(1 + 0.02 * torch.randn(channels))
        self.post_weight = nn.Parameter(1 + 0.02 * torch.randn(channels))
        self.post_bias = nn.Parameter(torch.zeros(channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(1, 2), keepdim=True)  # (B, 1, 1, C)
        m = mean.mean(dim=-1, keepdim=True)
        v = mean.var(dim=-1, keepdim=True, correction=1)
        mean_n = (mean - m) / torch.sqrt(v + 1e-5)
        inst = (x - mean) / torch.sqrt(x.var(dim=(1, 2), keepdim=True, correction=0) + 1e-5)
        h = inst * self.alpha * mean_n * self.post_weight
        return h if self.post_bias is None else h + self.post_bias


def _avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    return to_nhwc(F.avg_pool2d(to_nchw(x), 2, stride=2))


class RefineResidualBlock(nn.Module):
    """Pre-activation residual block (norm → ELU → conv, twice) with an
    optional 2× average-pool down step (at dilation 1 only) and a conv skip
    where the width or the resolution changes."""

    def __init__(self, in_channels: int, out_channels: int, resample: str | None = None, dilation: int = 1):
        super().__init__()
        mid = in_channels if resample == "down" else out_channels
        self.pool = dilation == 1 and resample is not None
        self.norm1 = InstanceNormPlus(in_channels)
        self.conv1 = CircularConv(in_channels, mid, 3, dilation, dilation)
        self.norm2 = InstanceNormPlus(mid)
        self.conv2 = CircularConv(mid, out_channels, 3, dilation, dilation)
        self.skip = None
        if in_channels != out_channels or resample is not None:
            self.skip = (CircularConv(in_channels, out_channels, 1, 0, 1) if dilation == 1
                         else CircularConv(in_channels, out_channels, 3, dilation, dilation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.elu(self.norm1(x)))
        h = self.conv2(F.elu(self.norm2(h)))
        skip = x
        if self.skip is not None:
            skip = self.skip(skip)
            if self.pool:
                h, skip = _avg_pool2x(h), _avg_pool2x(skip)
        return skip + h


class ResidualConvUnit(nn.Module):
    """``num_blocks`` residuals of ``num_stages`` (ELU → bias-free conv)."""

    def __init__(self, channels: int, num_blocks: int = 2, num_stages: int = 2):
        super().__init__()
        self.num_blocks, self.num_stages = num_blocks, num_stages
        for b in range(num_blocks):
            for s in range(num_stages):
                self.add_module(f"b{b}s{s}", CircularConv(channels, channels, 3, 1, use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for b in range(self.num_blocks):
            h = x
            for s in range(self.num_stages):
                h = self.get_submodule(f"b{b}s{s}")(F.elu(h))
            x = x + h
        return x


class ChainedResidualPooling(nn.Module):
    """ELU, then ``num_stages`` chained 5×5 max pools (stride 1), each
    through a bias-free conv and added."""

    def __init__(self, channels: int, num_stages: int = 2):
        super().__init__()
        self.num_stages = num_stages
        for s in range(num_stages):
            self.add_module(f"crp{s}", CircularConv(channels, channels, 3, 1, use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.elu(x)
        for s in range(self.num_stages):
            p = to_nhwc(F.max_pool2d(to_nchw(h), 5, stride=1, padding=2))
            h = h + self.get_submodule(f"crp{s}")(p)
        return h


class RefineBlock(nn.Module):
    """Each input through a residual conv unit (and, with several inputs, a
    conv to ``out_channels``), resized to the first input's shape and
    summed; then chained residual pooling and an output conv unit."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, num_end_blocks: int = 1):
        super().__init__()
        self.num_inputs = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"rcu{i}", ResidualConvUnit(c))
            if self.num_inputs > 1:
                self.add_module(f"adapt{i}", CircularConv(c, out_channels, 3, 1))
        ch = out_channels if self.num_inputs > 1 else in_channels[0]
        self.crp = ChainedResidualPooling(ch)
        self.out_rcu = ResidualConvUnit(ch, num_blocks=num_end_blocks)

    def forward(self, xs: Sequence[torch.Tensor], shape: tuple[int, int]) -> torch.Tensor:
        h = 0
        for i, x in enumerate(xs):
            r = self.get_submodule(f"rcu{i}")(x)
            if self.num_inputs > 1:
                r = self.get_submodule(f"adapt{i}")(r)
            h = h + bilinear_resize_align_corners(r, tuple(shape))
        return self.out_rcu(self.crp(h))


class LiDARGenRefineNet(nn.Module):
    """``forward(images (B, H, W, C), timesteps=None)`` → (B, H, W, out);
    the timesteps are not read (NCSN-style).  Two coordinate channels (the
    normalised row and column, linspace(0, 1)) join the input."""

    def __init__(
        self,
        in_channels: int,
        resolution: tuple[int, int],
        out_channels: int | None = None,
        base_channels: int = 128,
        channel_multiplier: Sequence[int] = (1, 2, 2, 2),
    ):
        super().__init__()
        H, W = resolution
        gp, gt = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
        self.register_buffer("coords", torch.as_tensor(np.stack([gp, gt], -1)), persistent=False)
        C = [base_channels] + [base_channels * m for m in channel_multiplier]
        self.in_conv = nn.Conv2d(in_channels + 2, C[0], 3, padding=1)
        self.d1a = RefineResidualBlock(C[0], C[1])
        self.d1b = RefineResidualBlock(C[1], C[1])
        self.d2a = RefineResidualBlock(C[1], C[2], resample="down")
        self.d2b = RefineResidualBlock(C[2], C[2])
        self.d3a = RefineResidualBlock(C[2], C[3], resample="down", dilation=2)
        self.d3b = RefineResidualBlock(C[3], C[3], dilation=2)
        self.d4a = RefineResidualBlock(C[3], C[4], resample="down", dilation=4)
        self.d4b = RefineResidualBlock(C[4], C[4], dilation=4)
        self.u4 = RefineBlock([C[4]], C[3])
        self.u3 = RefineBlock([C[3], C[4]], C[2])
        self.u2 = RefineBlock([C[2], C[2]], C[1])
        self.u1 = RefineBlock([C[1], C[1]], C[0], num_end_blocks=3)
        self.out_norm = InstanceNormPlus(C[0])
        self.out_conv = nn.Conv2d(C[0], out_channels or in_channels, 3, padding=1)

    def forward(self, images: torch.Tensor, _timesteps=None) -> torch.Tensor:
        B = images.shape[0]
        coords = self.coords.to(images.dtype)[None].expand(B, -1, -1, -1)
        h = to_nhwc(self.in_conv(to_nchw(torch.cat([images, coords], dim=-1))))
        h1 = self.d1b(self.d1a(h))
        h2 = self.d2b(self.d2a(h1))
        h3 = self.d3b(self.d3a(h2))
        h4 = self.d4b(self.d4a(h3))
        u = self.u4([h4], h4.shape[1:3])
        u = self.u3([h3, u], h3.shape[1:3])
        u = self.u2([h2, u], h2.shape[1:3])
        u = self.u1([h1, u], h1.shape[1:3])
        return to_nhwc(self.out_conv(to_nchw(F.elu(self.out_norm(u)))))
