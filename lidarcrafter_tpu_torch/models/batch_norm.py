"""BatchNorm as flax's ``nn.BatchNorm`` computes it, for the models that
train their statistics (PointMLP, GLENet).

``torch.nn.BatchNorm1d`` differs from flax in two ways that change the
running statistics a trainer leaves behind: it updates the running variance
with the unbiased batch variance, and its ``momentum`` weighs the new batch
(flax's weighs the old average).  :class:`BatchNorm` keeps flax's rule:

- train: normalise with the batch mean and the biased variance
  ``max(0, E[x²] − E[x]²)`` over every axis but the last, and update
  ``running = momentum · running + (1 − momentum) · batch``;
- eval: normalise with the running statistics;
- ``y = (x − mean) · (rsqrt(var + eps) · weight) + bias``.

It carries flax's state: ``weight`` / ``bias`` (flax ``scale`` / ``bias``)
and the buffers ``running_mean`` / ``running_var`` (``batch_stats``
``mean`` / ``var``), so a flax variable dict loads through
``weights.load_flax_params``.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Over the last axis of (..., C); flax's defaults (momentum 0.99,
    eps 1e-5)."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dims)
            var = torch.clamp(x.square().mean(dims) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
