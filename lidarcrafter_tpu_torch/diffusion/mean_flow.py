"""MeanFlow: the training loss (a JVP through the model) and one-step
sampling.

Port of the JAX package's ``diffusion/mean_flow.py``.  ``loss`` takes
``u, du/dt = jvp(model, (z, t, r), (v, 1, 0))`` with ``torch.func.jvp``,
where the JAX package uses ``jax.jvp``; on the card the attention and
GroupNorm kernels carry their own forward-mode rules
(``kernels/attention.py``, ``kernels/groupnorm.py``).  The target
``u_tgt = v − (t − r)·du/dt`` is detached, so the loss back-propagates
through the primal ``u`` only.  Each draw comes from a ``torch.Generator``
in the JAX order, (t, r) and then the noise, unless the caller injects it.

``sample`` takes an optional ``z`` and a ``torch.Generator``, so a caller
can hand it the same noise as the JAX sampler draws.  ``dtype`` is the
serving precision of the model call: z, t and r go in as ``dtype``, u comes
back float32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..draws import Rows


def adaptive_l2_loss(error: torch.Tensor, gamma: float = 0.5, c: float = 1e-3) -> torch.Tensor:
    """sg(w)·‖Δ‖² with w = 1 / (‖Δ‖² + c)^(1−γ), ‖Δ‖² the per-sample mean
    square, averaged over the batch."""
    delta_sq = error.square().mean(dim=tuple(range(1, error.ndim)))
    w = 1.0 / (delta_sq + c) ** (1.0 - gamma)
    return (w.detach() * delta_sq).mean()


@dataclasses.dataclass
class MeanFlow:
    """``model(z, t, r)`` predicts the average velocity u over [r, t]."""

    model: nn.Module
    sampling_shape: tuple[int, ...]  # (H, W, C) — without batch
    flow_ratio: float = 0.50
    time_mu: float = -0.4
    time_sigma: float = 1.0
    time_dist: str = "lognorm"
    dtype: torch.dtype = torch.float32  # of the serving model call (parameters cast by the caller)

    def sample_t_r(
        self, batch_size: int, generator: torch.Generator | None = None, device=None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(t, r) of a batch: two draws per sample, lognorm (sigmoid of a
        normal) or uniform, t the larger and r the smaller; then the first
        ``int(flow_ratio·B)`` of a random permutation get r = t."""
        if self.time_dist == "uniform":
            samples = torch.rand((batch_size, 2), generator=generator, device=device)
        elif self.time_dist == "lognorm":
            normal = torch.randn((batch_size, 2), generator=generator, device=device)
            samples = torch.sigmoid(normal * self.time_sigma + self.time_mu)
        else:
            raise ValueError(self.time_dist)
        t, r = samples.max(dim=1).values, samples.min(dim=1).values
        idx = torch.randperm(batch_size, generator=generator, device=device)[: int(self.flow_ratio * batch_size)]
        r = r.index_copy(0, idx, t[idx])
        return t, r

    def loss(
        self,
        x: torch.Tensor,
        generator: torch.Generator | None = None,
        t: torch.Tensor | None = None,
        r: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        rows: Rows | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(adaptive L2 loss, mse) of ``x`` (B, H, W, C): z = (1−t)·x + t·e,
        v = e − x, u_tgt = v − (t−r)·du/dt.  t and r (B,), then the noise e,
        are drawn from ``generator`` unless given (t and r together), at the
        global batch's size with this rank's ``rows`` kept (all rows by
        default)."""
        B = x.shape[0]
        rows = rows or Rows.whole(B)
        if t is None:
            t, r = (rows.cut(a) for a in self.sample_t_r(rows.total, generator, x.device))
        e = rows.randn(generator, x.device, x.shape[1:], x.dtype) if noise is None else noise
        t_, r_ = (a.reshape(B, *([1] * (x.ndim - 1))) for a in (t, r))
        z = (1 - t_) * x + t_ * e
        v = e - x
        u, dudt = torch.func.jvp(self.model, (z, t, r), (v, torch.ones_like(t), torch.zeros_like(r)))
        u_tgt = v - (t_ - r_) * dudt
        error = u - u_tgt.detach()
        return adaptive_l2_loss(error), error.detach().square().mean()

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
