"""Discrete-time Gaussian diffusion (DDPM): the loss and the DDPM / DDIM
sampler.

Port of the JAX package's ``diffusion/discrete.py`` (``DiscreteDiffusion``):
the beta, alpha-bar, previous alpha-bar and SNR tables are computed on the
host in float64 (linear, cosine or sigmoid schedule), held in float32 on
the model's device, and indexed by the integer timesteps, which the
denoiser receives as they are.  ``p_loss`` / ``p_step`` take their noise as
an optional input and otherwise draw it from a ``torch.Generator``, so a
caller can inject the JAX key chain's draws.  ``dtype`` is the serving
precision of the denoiser call, as in :class:`ContinuousDiffusion`.

Data parallelism and the mesh's ``sp`` axis as in the continuous engine: the
loss draws its timesteps and noise at the global batch's size and keeps this
rank's ``rows`` (and columns), its per-sample sums span the ``sp`` ranks
before the division, and ``sample(..., mesh=)`` runs the reverse loop on
this rank's share of x_T and of each step's draws, gathering x_0 at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch
from torch import nn

from ..draws import Rows
from ..parallel.mesh import Mesh, azimuth, batch_sharding
from . import schedules
from .continuous import _bcast

_BETAS = {
    "linear": schedules.beta_schedule_linear,
    "cosine": schedules.beta_schedule_cosine,
    "sigmoid": schedules.beta_schedule_sigmoid,
}


def tables_np(noise_schedule: str, T: int) -> tuple[np.ndarray, ...]:
    """(beta, alpha_bar, alpha_bar_prev, snr), computed in float64 and
    returned as float32 arrays of T values."""
    if noise_schedule not in _BETAS:
        raise ValueError(noise_schedule)
    beta = np.asarray(_BETAS[noise_schedule](T), np.float64)
    alpha_bar = np.cumprod(1 - beta)
    alpha_bar_prev = np.concatenate([[1.0], alpha_bar[:-1]])
    snr = alpha_bar / (1 - alpha_bar)
    return tuple(a.astype(np.float32) for a in (beta, alpha_bar, alpha_bar_prev, snr))


@dataclasses.dataclass
class DiscreteDiffusion:
    """``model(x_t, steps)`` predicts eps / v / x_0; ``steps`` are integer
    indices into the tables."""

    model: nn.Module
    sampling_shape: tuple[int, ...]
    num_training_steps: int = 1000
    prediction_type: Literal["eps", "v", "x_0"] = "eps"
    loss_type: Literal["l2", "l1", "huber"] = "l2"
    noise_schedule: str = "linear"
    min_snr_loss_weight: bool = True
    min_snr_gamma: float = 5.0
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    dtype: torch.dtype = torch.float32  # of the denoiser call (parameters cast by the caller)
    _tables: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def tables(self, device) -> tuple[torch.Tensor, ...]:
        """The four float32 tables on ``device``, made once per device (a
        host copy inside the sampling loop would wait for the card)."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.as_tensor(a, device=device) for a in tables_np(self.noise_schedule, self.num_training_steps)
            )
        return self._tables[device]

    def _at(self, which: int, steps: torch.Tensor, ndim: int) -> torch.Tensor:
        return _bcast(self.tables(steps.device)[which][steps], ndim)

    def denoise(self, x_t: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        """One denoiser call on the integer ``steps``; the image goes in as
        ``dtype`` and the prediction comes back float32."""
        return self.model(x_t.to(self.dtype), steps).float()

    def criterion(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.loss_type == "l2":
            return (pred - target) ** 2
        if self.loss_type == "l1":
            return torch.abs(pred - target)
        if self.loss_type == "huber":
            diff = torch.abs(pred - target)
            return torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)
        raise ValueError(self.loss_type)

    def get_target(self, x_0: torch.Tensor, steps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "eps":
            return noise
        if self.prediction_type == "x_0":
            return x_0
        if self.prediction_type == "v":
            ab = self._at(1, steps, x_0.ndim)
            return torch.sqrt(ab) * noise - torch.sqrt(1 - ab) * x_0
        raise ValueError(self.prediction_type)

    def get_loss_weight(self, steps: torch.Tensor) -> torch.Tensor:
        snr = self.tables(steps.device)[3][steps]
        clipped = torch.clamp(snr, max=self.min_snr_gamma) if self.min_snr_loss_weight else snr
        if self.prediction_type == "eps":
            return clipped / snr
        if self.prediction_type == "x_0":
            return clipped
        if self.prediction_type == "v":
            return clipped / (snr + 1)
        raise ValueError(self.prediction_type)

    def q_step_from_x_0(
        self,
        x_0: torch.Tensor,
        steps: torch.Tensor,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """q(x_t | x_0); the noise is drawn from ``generator`` unless given.
        Returns (x_t, noise)."""
        if noise is None:
            noise = torch.randn(x_0.shape, generator=generator, device=x_0.device, dtype=x_0.dtype)
        ab = self._at(1, steps, x_0.ndim)
        return torch.sqrt(ab) * x_0 + torch.sqrt(1 - ab) * noise, noise

    def p_loss(
        self,
        x_0: torch.Tensor,
        steps: torch.Tensor,
        noise: torch.Tensor | None = None,
        loss_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The per-sample masked loss with the min-SNR weight at integer
        ``steps`` (B,), averaged over the batch."""
        loss_mask = torch.ones_like(x_0) if loss_mask is None else loss_mask
        x_t, noise = self.q_step_from_x_0(x_0, steps, noise, generator)
        loss = self.criterion(self.denoise(x_t, steps), self.get_target(x_0, steps, noise))
        axes = tuple(range(1, x_0.ndim))
        total, count = torch.sum(loss * loss_mask, dim=axes), torch.sum(loss_mask, dim=axes)
        mesh = azimuth()
        if mesh is not None:  # the sample's sums over every rank's columns
            total, count = mesh.sum_sp(torch.stack([total, count])).unbind(0)
        return torch.mean(total / (count + 1e-8) * self.get_loss_weight(steps))

    def loss(
        self,
        x_0: torch.Tensor,
        generator: torch.Generator | None = None,
        loss_mask: torch.Tensor | None = None,
        steps: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        rows: Rows | None = None,
    ) -> torch.Tensor:
        """Training loss at uniform integer timesteps in [0, T): ``steps``,
        then the noise, drawn from ``generator`` unless given, at the global
        batch's size with this rank's ``rows`` kept (all rows by default)."""
        rows = rows or Rows.whole(x_0.shape[0])
        if steps is None:
            steps = rows.randint(self.num_training_steps, generator, x_0.device)
        if noise is None:
            noise = rows.randn(generator, x_0.device, x_0.shape[1:], x_0.dtype)
        return self.p_loss(x_0, steps, noise, loss_mask, generator)

    def p_step(
        self,
        x_t: torch.Tensor,
        steps: torch.Tensor,
        mode: Literal["ddpm", "ddim"] = "ddim",
        eta: float = 0.0,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
        rows: Rows | None = None,
    ) -> torch.Tensor:
        """One reverse step from integer ``steps`` to the step before; no
        noise at step 0.  The noise is drawn from ``generator`` unless given
        (DDIM with eta 0 draws none; at the whole batch's size, cut to
        ``rows``, when given)."""
        n = x_t.ndim
        beta = self._at(0, steps, n)
        alpha = 1 - beta
        ab, abp = self._at(1, steps, n), self._at(2, steps, n)
        prediction = self.denoise(x_t, steps)
        if self.prediction_type == "eps":
            x_0 = torch.rsqrt(ab) * x_t - torch.sqrt(1.0 / ab - 1) * prediction
        elif self.prediction_type == "x_0":
            x_0 = prediction
        elif self.prediction_type == "v":
            x_0 = torch.sqrt(ab) * x_t - torch.sqrt(1 - ab) * prediction
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x_0 = torch.clamp(x_0, -self.clip_sample_range, self.clip_sample_range)

        def draw():
            rows_ = rows or Rows.whole(x_t.shape[0])
            z = noise if noise is not None else rows_.randn(generator, x_t.device, x_t.shape[1:], x_t.dtype)
            return z * (1 - _bcast((steps == 0).to(x_t.dtype), n))

        if mode == "ddpm":
            x0c = torch.sqrt(abp) * beta / (1 - ab)
            xtc = (1 - abp) * torch.sqrt(alpha) / (1 - ab)
            var = torch.clamp(beta * (1 - abp) / (1 - ab), min=1e-20)
            return x0c * x_0 + xtc * x_t + torch.exp(0.5 * torch.log(var)) * draw()
        if mode == "ddim":
            var = (1 - abp) / (1 - ab) * (1 - ab / abp)
            std = eta * torch.sqrt(var)
            eps = (x_t - torch.sqrt(ab) * x_0) / torch.sqrt(1 - ab)
            x_s = torch.sqrt(abp) * x_0 + torch.sqrt(1 - abp - std**2) * eps
            return x_s + std * draw() if eta > 0 else x_s
        raise ValueError(mode)

    def reverse(self, x: torch.Tensor, num_steps: int, mode: Literal["ddpm", "ddim"],
                generator: torch.Generator | None = None, rows: Rows | None = None) -> torch.Tensor:
        """x_T → x_0 through the integer steps num_steps - 1, ..., 0; each
        step's noise from ``generator`` (this rank's ``rows`` of the whole
        draw, when given)."""
        for i in range(num_steps):
            steps = torch.full((x.shape[0],), num_steps - 1 - i, dtype=torch.int64, device=x.device)
            x = self.p_step(x, steps, mode=mode, generator=generator, rows=rows)
        return x

    @torch.inference_mode()
    def sample(
        self,
        batch_size: int,
        num_steps: int,
        mode: Literal["ddpm", "ddim"] = "ddpm",
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        mesh: Mesh | None = None,
    ) -> torch.Tensor:
        """From ``x_T`` (drawn from ``generator`` when not given) through the
        integer steps num_steps - 1, ..., 0; returns x_0 (B, *sampling_shape).
        On a ``mesh`` each rank denoises its rows and columns of x_T (and of
        each step's draws) with the layers sharded over ``sp``, and every
        rank returns the whole x_0."""
        device = next(self.model.parameters()).device
        if x_T is None:
            x = torch.randn((batch_size, *self.sampling_shape), generator=generator, device=device)
        else:
            x = x_T.to(device=device, dtype=torch.float32)
        if mesh is None:
            return self.reverse(x, num_steps, mode, generator)
        sharding = batch_sharding(mesh, x.ndim, sp_axis=2)
        with mesh.active():
            x_0 = self.reverse(sharding.cut(x), num_steps, mode, generator, sharding.rows(x.shape[0], x.shape[2]))
        return sharding.gather(x_0)
