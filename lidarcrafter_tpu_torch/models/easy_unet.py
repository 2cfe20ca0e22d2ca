"""Trivial condition encoders: ``Identity`` and ``SpatialRescaler``
(registry keys ``identity`` and ``easy_unet``), NHWC.

Port of the JAX package's ``models/easy_unet.py``.  Both pass the raw
condition ``data_dict['cond']`` through; the rescaler first resizes it by
each (h, w) stride in turn (align-corners bilinear, as
``torch.nn.functional.interpolate(..., align_corners=True)``, or nearest)
and then remaps its channels with a 1×1 conv.  Plain PyTorch: the JAX
package computes these in XLA.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .ops import to_nchw, to_nhwc


class Identity(nn.Module):
    """Returns ``data_dict['cond']`` unchanged."""

    def __init__(self, out_channels: int = 0):
        super().__init__()

    def forward(self, data_dict: dict) -> torch.Tensor:
        return data_dict["cond"]


def _resize_axis_align_corners(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Linear resampling along ``axis`` with align-corners semantics: output
    sample i reads input coordinate i·(in − 1)/(out − 1)."""
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    if out_size == 1 or in_size == 1:
        return x.index_select(axis, torch.zeros(out_size, dtype=torch.long, device=x.device))
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device) * (in_size - 1) / (out_size - 1)
    lo = torch.clamp(torch.floor(pos).to(torch.long), 0, in_size - 2)
    frac = pos - lo.to(torch.float32)
    a = x.index_select(axis, lo)
    b = x.index_select(axis, lo + 1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = frac.reshape(shape)
    return a * (1.0 - w) + b * w


def bilinear_resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with align-corners semantics, H first, then W."""
    x = _resize_axis_align_corners(x, 1, out_hw[0])
    return _resize_axis_align_corners(x, 2, out_hw[1])


class SpatialRescaler(nn.Module):
    """A chain of (h_stride, w_stride) downsamples of the condition (output
    size floor(in / stride), as ``interpolate(scale_factor=1/stride)``),
    ``method`` ``bilinear`` (``linear`` and ``trilinear`` too) or
    ``nearest``, then an optional 1×1 ``channel_mapper`` conv to
    ``out_channels``."""

    def __init__(
        self,
        strides: Sequence[tuple[int, int]] = (),
        method: str = "bilinear",
        in_channels: int = 3,
        out_channels: int | None = None,
        bias: bool = False,
    ):
        super().__init__()
        if method not in ("bilinear", "linear", "trilinear", "nearest"):
            raise NotImplementedError(method)
        self.strides = tuple(tuple(s) for s in strides)
        self.method = method
        self.channel_mapper = (
            None if out_channels is None else nn.Conv2d(in_channels, out_channels, 1, bias=bias)
        )

    def forward(self, data_dict: dict) -> torch.Tensor:
        x = data_dict["cond"]
        for h_s, w_s in self.strides:
            out_hw = (int(x.shape[1] // h_s), int(x.shape[2] // w_s))
            if self.method == "nearest":
                hi = torch.arange(out_hw[0], device=x.device) * x.shape[1] // out_hw[0]
                wi = torch.arange(out_hw[1], device=x.device) * x.shape[2] // out_hw[1]
                x = x[:, hi][:, :, wi]
            else:
                x = bilinear_resize_align_corners(x, out_hw)
        if self.channel_mapper is not None:
            x = to_nhwc(self.channel_mapper(to_nchw(x)))
        return x
