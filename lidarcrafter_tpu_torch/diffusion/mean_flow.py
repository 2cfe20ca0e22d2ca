"""MeanFlow one-step sampling.

Port of ``MeanFlow.sample`` of the JAX package's ``diffusion/mean_flow.py``:
x = z − u(z, t=1, r=0).  ``sample`` takes an optional ``z`` and a
``torch.Generator``, so a caller can hand it the same noise as the JAX
sampler draws.  ``dtype`` is the serving precision of the model call: z, t
and r go in as ``dtype``, u comes back float32.  The training loss (a JVP
through the model) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class MeanFlow:
    """``model(z, t, r)`` predicts the average velocity u over [r, t]."""

    model: nn.Module
    sampling_shape: tuple[int, ...]  # (H, W, C) — without batch
    dtype: torch.dtype = torch.float32  # of the model call (parameters cast by the caller)

    @torch.inference_mode()
    def sample(
        self,
        batch_size: int = 1,
        z: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """One step from noise ``z`` (drawn from ``generator`` when not
        given) at t = 1 to r = 0; returns (B, H, W, C)."""
        device = next(self.model.parameters()).device
        if z is None:
            z = torch.randn(
                (batch_size, *self.sampling_shape), generator=generator,
                device=device, dtype=torch.float32,
            )
        else:
            z = z.to(device=device, dtype=torch.float32)
        t = torch.ones(z.shape[0], device=device, dtype=self.dtype)
        r = torch.zeros(z.shape[0], device=device, dtype=self.dtype)
        return z - self.model(z.to(self.dtype), t, r).float()
