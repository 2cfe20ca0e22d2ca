"""Continuous-time Gaussian diffusion: the training losses, the
unconditional sampler, the timestep grids and the DPM-Solver++(2M)
multistep solver, and RePaint inpainting.

Port of the JAX package's ``diffusion/continuous.py``: the losses
(``criterion``, ``get_target``, ``get_loss_weight`` with min-SNR-γ,
``q_step_from_x_0``, ``q_step``, ``p_loss``, ``loss``) line for line, and
the sampling half (``predict_x_0`` / ``p_step`` / ``sample``,
``lambda_spaced_timesteps``, ``dpmpp_2m_scan``), whose ``lax.scan`` loops
become Python loops of denoiser calls.  ``p_loss`` takes ``t`` and the
noise as optional inputs and ``loss`` draws them from a ``torch.Generator``
(the JAX package draws them from its key), so a caller can inject the JAX
key chain's draws.  ``sample`` takes an optional ``x_T``
and a ``torch.Generator``, so a caller can hand it the same start as the JAX
sampler draws.  ``repaint`` (alias ``inpaint``) runs the unrolled (step,
resample) schedule of RePaint with ``jump_length`` as nested Python loops;
its normal draws come from a ``draw(kind, index, k)`` callable when given,
so a caller can hand it the JAX key chain's draws.  The conditional sampler
(``conditional.py``) shares all of it and only changes how the denoiser is
called.

``dtype`` is the serving precision of the denoiser call, as the JAX
package's ``build_sampler_fn`` sets it: the image and the time input go in
as ``dtype`` and the prediction comes back float32, so the schedules, the
sampler's carry and the clipping stay float32.

Under the mesh's ``sp`` axis (``parallel/mesh.py``) the loss's per-sample
sums are summed over the ranks before the division, so that a sample's
masked mean spans every rank's columns; ``sample(..., mesh=)`` runs the
reverse loop on this rank's share of the whole x_T (and of each step's
draws) and gathers the frames at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import numpy as np
import torch
from torch import nn

from ..draws import Rows
from ..parallel.mesh import Mesh, azimuth, batch_sharding
from . import schedules


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast (B,) → (B, 1, 1, ...) for ``ndim`` total dims."""
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


def linspace_timesteps(num_steps: int, device=None) -> torch.Tensor:
    """The uniform t grid (1.0 → 0.0 inclusive), float32."""
    return torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)


def lambda_spaced_timesteps(
    log_snr_fn: Callable[[torch.Tensor], torch.Tensor],
    num_steps: int,
    dense: int = 4096,
    device=None,
) -> torch.Tensor:
    """A t grid (1.0 → 0.0 inclusive) uniform in λ = ½·log-SNR.

    DPM-Solver++'s local error scales with (Δλ)³, so equal λ steps spread the
    error evenly.  The inverse of λ(t) comes from linear interpolation on a
    dense float32 table, as in the JAX package.
    """
    t_dense = torch.linspace(0.0, 1.0, dense + 1, dtype=torch.float32)
    lam = (0.5 * log_snr_fn(t_dense)).numpy()  # decreasing in t
    lam_grid = np.linspace(lam[-1], lam[0], num_steps + 1, dtype=np.float32)
    t_grid = np.interp(lam_grid, lam[::-1], t_dense.numpy()[::-1]).astype(np.float32)
    t_grid[0], t_grid[-1] = 1.0, 0.0  # pin the endpoints exactly
    return torch.as_tensor(t_grid, device=device)


def dpmpp_2m_coefficients(
    steps: torch.Tensor, log_snr_fn: Callable[[torch.Tensor], torch.Tensor]
) -> tuple[list[float], list[float], list[float]]:
    """λ = ½·log-SNR, α and σ at each t of the host grid ``steps``, as
    Python floats."""
    log_snr = log_snr_fn(steps)
    alpha, sigma = schedules.log_snr_to_alpha_sigma(log_snr)
    return (0.5 * log_snr).tolist(), alpha.tolist(), sigma.tolist()


def dpmpp_2m(
    x: torch.Tensor,
    coefficients: tuple[list[float], list[float], list[float]],
    x0_fn: Callable[[torch.Tensor, int], torch.Tensor],
) -> torch.Tensor:
    """DPM-Solver++(2M) in data-prediction form (arXiv:2211.01095, Alg. 2).

    ``coefficients`` are :func:`dpmpp_2m_coefficients` of the
    (num_steps+1,) t grid; ``x0_fn(x, i)`` evaluates x̂_0 at the grid's
    ``i``-th t.  The first step (no history) and the last step (the
    λ-extrapolation overshoots on the clamped jump into t=0) are first order.
    """
    lam, alpha, sigma = coefficients
    num_steps = len(lam) - 1
    x0_prev = None
    for i in range(num_steps):
        x0 = x0_fn(x, i)
        h = lam[i + 1] - lam[i]
        if i == 0 or i == num_steps - 1:
            d = x0
        else:
            r = (lam[i] - lam[i - 1]) / h
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        x = (sigma[i + 1] / sigma[i]) * x - alpha[i + 1] * float(np.expm1(-h)) * d
        x0_prev = x0
    return x


@dataclasses.dataclass(frozen=True)
class ReversePlan:
    """The host side of a reverse loop: its t grid and, for DPM++(2M), the
    solver's (λ, α, σ) on it, all Python floats.  Computing it reads
    tensors back, so an exported sampler computes it before tracing."""

    mode: str
    grid: list[float]
    coefficients: tuple[list[float], list[float], list[float]] | None = None

    @property
    def num_steps(self) -> int:
        return len(self.grid) - 1


@dataclasses.dataclass
class ContinuousDiffusion:
    """Continuous-time Gaussian diffusion (VDM parameterisation);
    ``model(x_t, log_snr_t)`` predicts eps / v / x_0."""

    model: nn.Module
    # one sample's shape, without the batch axis: (H, W, C) for a range
    # image, (num_points, point_dim) for an object cloud, (C,) for a layout node
    sampling_shape: tuple[int, ...]
    prediction_type: Literal["eps", "v", "x_0"] = "eps"
    loss_type: Literal["l2", "l1", "huber"] = "l2"
    noise_schedule: str = "cosine"
    min_snr_loss_weight: bool = True
    min_snr_gamma: float = 5.0
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    image_d: float | None = None
    noise_d_low: float | None = None
    noise_d_high: float | None = None
    dtype: torch.dtype = torch.float32  # of the denoiser call (parameters cast by the caller)

    def log_snr(self, t: torch.Tensor) -> torch.Tensor:
        fn = schedules.get_log_snr_fn(
            self.noise_schedule, self.image_d, self.noise_d_low, self.noise_d_high
        )
        return fn(t)

    def denoise(self, x_t: torch.Tensor, log_snr_t: torch.Tensor, condition=None) -> torch.Tensor:
        """One denoiser call; the network sees log-SNR(t), not t.  Image and
        time go in as ``dtype``; the prediction comes back float32."""
        return self.model(x_t.to(self.dtype), log_snr_t.to(self.dtype)).float()

    # ------------------------------------------------------------------ losses

    def criterion(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Unreduced loss."""
        if self.loss_type == "l2":
            return (pred - target) ** 2
        if self.loss_type == "l1":
            return torch.abs(pred - target)
        if self.loss_type == "huber":  # SmoothL1 with beta=1
            diff = torch.abs(pred - target)
            return torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)
        raise ValueError(self.loss_type)

    def get_target(self, x_0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "eps":
            return noise
        if self.prediction_type == "x_0":
            return x_0
        if self.prediction_type == "v":
            alpha, sigma = schedules.log_snr_to_alpha_sigma(_bcast(self.log_snr(t), x_0.ndim))
            return alpha * noise - sigma * x_0
        raise ValueError(self.prediction_type)

    def get_loss_weight(self, t: torch.Tensor) -> torch.Tensor:
        """min-SNR-γ weighting."""
        snr = torch.exp(self.log_snr(t))
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
        t: torch.Tensor,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Forward process q(z_t | x_0); the noise is drawn from
        ``generator`` unless given.  Returns (z_t, noise)."""
        if noise is None:
            noise = torch.randn(x_0.shape, generator=generator, device=x_0.device, dtype=x_0.dtype)
        alpha, sigma = schedules.log_snr_to_alpha_sigma(_bcast(self.log_snr(t), x_0.ndim))
        return x_0 * alpha + noise * sigma, noise

    def q_step(
        self,
        x_s: torch.Tensor,
        t: torch.Tensor,
        s: torch.Tensor,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """q(z_t | z_s), 0 < s < t < 1."""
        alpha_t, sigma_t = schedules.log_snr_to_alpha_sigma(_bcast(self.log_snr(t), x_s.ndim))
        alpha_s, sigma_s = schedules.log_snr_to_alpha_sigma(_bcast(self.log_snr(s), x_s.ndim))
        alpha_ts = alpha_t / alpha_s
        if noise is None:
            noise = torch.randn(x_s.shape, generator=generator, device=x_s.device, dtype=x_s.dtype)
        var = sigma_t**2 - alpha_ts**2 * sigma_s**2
        return x_s * alpha_ts + torch.sqrt(var) * noise

    def weighted_loss(self, x_0, t, noise, loss_mask, condition=None, generator=None) -> torch.Tensor:
        """The per-sample masked loss with the min-SNR weight, averaged over
        the batch, of one denoiser call on q(z_t | x_0); the shared body of
        both engines' ``p_loss``."""
        loss_mask = torch.ones_like(x_0) if loss_mask is None else loss_mask
        x_t, noise = self.q_step_from_x_0(x_0, t, noise, generator)
        prediction = self.denoise(x_t, self.log_snr(t), condition)
        loss = self.criterion(prediction, self.get_target(x_0, t, noise))
        axes = tuple(range(1, x_0.ndim))
        total, count = torch.sum(loss * loss_mask, dim=axes), torch.sum(loss_mask, dim=axes)
        mesh = azimuth()
        if mesh is not None:  # the sample's sums over every rank's columns
            total, count = mesh.sum_sp(torch.stack([total, count])).unbind(0)
        loss = total / (count + 1e-8)
        return torch.mean(loss * self.get_loss_weight(t))

    def p_loss(
        self,
        x_0: torch.Tensor,
        t: torch.Tensor,
        noise: torch.Tensor | None = None,
        loss_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The loss at timesteps ``t`` (B,); the noise is drawn from
        ``generator`` unless given."""
        return self.weighted_loss(x_0, t, noise, loss_mask, generator=generator)

    def draw(self, x_0: torch.Tensor, generator: torch.Generator | None, rows: Rows | None = None,
             t: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        """A loss's draws, each unless given: uniform continuous timesteps
        (B,) float32, then the noise like ``x_0``; at the global batch's size
        with this rank's ``rows`` kept (all rows by default)."""
        rows = rows or Rows.whole(x_0.shape[0])
        t = rows.rand(generator, x_0.device) if t is None else t
        noise = rows.randn(generator, x_0.device, x_0.shape[1:], x_0.dtype) if noise is None else noise
        return t, noise

    def loss(
        self,
        x_0: torch.Tensor,
        generator: torch.Generator | None = None,
        loss_mask: torch.Tensor | None = None,
        t: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        rows: Rows | None = None,
    ) -> torch.Tensor:
        """Training loss with uniform continuous timesteps: ``t``, then the
        noise, drawn from ``generator`` unless given (:meth:`draw`)."""
        t, noise = self.draw(x_0, generator, rows, t, noise)
        return self.p_loss(x_0, t, noise, loss_mask, generator)

    def predict_x_0(self, x_t: torch.Tensor, t: torch.Tensor, condition=None) -> torch.Tensor:
        """x̂_0 from one denoiser call (with clipping)."""
        log_snr_t = self.log_snr(t)
        alpha_t, sigma_t = schedules.log_snr_to_alpha_sigma(_bcast(log_snr_t, x_t.ndim))
        prediction = self.denoise(x_t, log_snr_t, condition)
        if self.prediction_type == "eps":
            x_0 = (x_t - sigma_t * prediction) / alpha_t
        elif self.prediction_type == "v":
            x_0 = alpha_t * x_t - sigma_t * prediction
        elif self.prediction_type == "x_0":
            x_0 = prediction
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x_0 = torch.clamp(x_0, -self.clip_sample_range, self.clip_sample_range)
        return x_0

    def p_step(
        self,
        x_t: torch.Tensor,
        t: torch.Tensor,
        s: torch.Tensor,
        mode: Literal["ddpm", "ddim"] = "ddpm",
        ddim_eta: float = 0.0,
        generator: torch.Generator | None = None,
        condition=None,
        noise: torch.Tensor | None = None,
        rows: Rows | None = None,
    ) -> torch.Tensor:
        """One reverse step p(z_s | z_t); its noise is drawn from
        ``generator`` unless given (at the whole batch's size, cut to
        ``rows``, when given)."""
        log_snr_t = _bcast(self.log_snr(t), x_t.ndim)
        log_snr_s = _bcast(self.log_snr(s), x_t.ndim)
        alpha_t, sigma_t = schedules.log_snr_to_alpha_sigma(log_snr_t)
        alpha_s, sigma_s = schedules.log_snr_to_alpha_sigma(log_snr_s)
        x_0 = self.predict_x_0(x_t, t, condition)

        def draw():
            if noise is not None:
                return noise
            if rows is not None:
                return rows.randn(generator, x_t.device, x_t.shape[1:], x_t.dtype)
            return torch.randn(
                x_t.shape, generator=generator, device=x_t.device, dtype=x_t.dtype
            )

        if mode == "ddpm":
            c = -torch.expm1(log_snr_t - log_snr_s)
            mean = alpha_s * (x_t * (1 - c) / alpha_t + c * x_0)
            return mean + sigma_s * torch.sqrt(c) * draw()
        if mode == "ddim":
            c_1 = ddim_eta * sigma_s / sigma_t * torch.sqrt(1 - alpha_t**2 / alpha_s**2)
            c_2 = torch.sqrt(1 - alpha_s**2 - c_1**2)
            eps = (x_t - alpha_t * x_0) / sigma_t
            out = alpha_s * x_0 + c_2 * eps
            # η = 0 is deterministic: no draw, so the generator is untouched
            return out + c_1 * draw() if ddim_eta else out
        raise ValueError(mode)

    def reverse_plan(self, num_steps: int, mode: Literal["ddpm", "ddim", "dpmpp_2m"]) -> ReversePlan:
        """The grid of :meth:`reverse`: uniform in λ for DPM++(2M), uniform
        in t for DDPM and DDIM.  It stays on the host: reading it back from
        the card would wait for the work queued before."""
        if mode == "dpmpp_2m":
            steps = lambda_spaced_timesteps(self.log_snr, num_steps)
            return ReversePlan(mode, steps.tolist(), dpmpp_2m_coefficients(steps, self.log_snr))
        if mode not in ("ddpm", "ddim"):
            raise ValueError(mode)
        return ReversePlan(mode, linspace_timesteps(num_steps).tolist())

    def reverse(
        self,
        x: torch.Tensor,
        num_steps: int,
        mode: Literal["ddpm", "ddim", "dpmpp_2m"],
        ddim_eta: float = 0.0,
        generator: torch.Generator | None = None,
        condition=None,
        plan: ReversePlan | None = None,
        noise: torch.Tensor | None = None,
        rows: Rows | None = None,
    ) -> torch.Tensor:
        """x_T → x_0 over :meth:`reverse_plan`'s grid (or ``plan``, made
        for this mode and ``num_steps``).  A step that draws noise (DDPM,
        DDIM with η > 0) takes ``noise[i]`` when ``noise`` is given, else
        draws from ``generator`` (this rank's ``rows`` of the whole draw,
        when given)."""
        B, device = x.shape[0], x.device
        plan = plan or self.reverse_plan(num_steps, mode)
        grid = plan.grid

        def t_full(v: float) -> torch.Tensor:
            return torch.full((B,), v, dtype=torch.float32, device=device)

        if mode == "dpmpp_2m":
            return dpmpp_2m(
                x, plan.coefficients,
                lambda xi, i: self.predict_x_0(xi, t_full(grid[i]), condition),
            )
        for i in range(num_steps):
            x = self.p_step(
                x, t_full(grid[i]), t_full(grid[i + 1]), mode=mode, ddim_eta=ddim_eta,
                generator=generator, condition=condition, noise=None if noise is None else noise[i],
                rows=rows,
            )
        return x

    def reverse_on_mesh(self, mesh: Mesh, x: torch.Tensor, num_steps: int, mode, ddim_eta: float = 0.0,
                        generator: torch.Generator | None = None, condition=None) -> torch.Tensor:
        """:meth:`reverse` of the whole x_T ``x`` (B, H, W, C) on ``mesh``:
        this rank's rows and columns of it, and of each step's draws, with
        the layers sharded over ``sp``; the whole x_0 gathered on every
        rank.  ``condition`` is this rank's share of the network condition."""
        sharding = batch_sharding(mesh, x.ndim, sp_axis=2)
        with mesh.active():
            x_0 = self.reverse(sharding.cut(x), num_steps, mode, ddim_eta, generator, condition,
                               rows=sharding.rows(x.shape[0], x.shape[2]))
        return sharding.gather(x_0)

    def start(
        self,
        batch_size: int,
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``x_T``, or a standard normal draw from ``generator``, as float32
        on the model's device."""
        device = next(self.model.parameters()).device
        if x_T is not None:
            return x_T.to(device=device, dtype=torch.float32)
        return torch.randn(
            (batch_size, *self.sampling_shape), generator=generator,
            device=device, dtype=torch.float32,
        )

    @torch.inference_mode()
    def sample(
        self,
        batch_size: int,
        num_steps: int,
        mode: Literal["ddpm", "ddim", "dpmpp_2m"] = "ddpm",
        ddim_eta: float = 0.0,
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        mesh: Mesh | None = None,
    ) -> torch.Tensor:
        """Unconditional sampling from ``x_T`` (drawn from ``generator`` when
        not given); returns x_0 (B, *sampling_shape).  On a ``mesh`` each
        rank denoises its share (:meth:`reverse_on_mesh`) and every rank
        returns the whole x_0."""
        x = self.start(batch_size, x_T, generator)
        if mesh is not None:
            return self.reverse_on_mesh(mesh, x, num_steps, mode, ddim_eta, generator)
        return self.reverse(x, num_steps, mode, ddim_eta, generator)

    def repaint_loop(
        self,
        x_t: torch.Tensor,
        known: torch.Tensor,
        mask: torch.Tensor,
        num_steps: int,
        num_resample_steps: int = 1,
        jump_length: int = 1,
        generator: torch.Generator | None = None,
        draw: Callable[[str, int, int], torch.Tensor] | None = None,
        condition=None,
    ) -> torch.Tensor:
        """RePaint (arXiv:2201.09865) from ``x_t`` over the uniform t grid:
        for each of the ``num_steps`` steps, ``num_resample_steps`` times,
        ``jump_length`` DDPM steps through the sub-grid between t and s,
        each followed by pasting the known region (``mask`` = 1) noised to
        the same time, then, except on a step's last resampling and on the
        last step, diffusing back from s to t.  Returns the x_s of the last
        iteration.

        ``draw(kind, index, k)`` gives the normal draw (float32, x's shape)
        of the known region's noising (``"known"``), of the DDPM step
        (``"reverse"``) or of the forward jump (``"forward"``), at outer
        iteration ``index`` (step-major) and inner step ``k``; by default
        they come from ``generator``."""
        if num_resample_steps < 1 or jump_length < 1:
            raise ValueError("num_resample_steps and jump_length must be positive")
        B = x_t.shape[0]
        known = known.to(x_t)
        mask = mask.to(x_t)
        if draw is None:
            def draw(kind, index, k):
                return torch.randn(x_t.shape, generator=generator, device=x_t.device, dtype=torch.float32)

        def t_full(v) -> torch.Tensor:
            return torch.full((B,), float(v), dtype=torch.float32, device=x_t.device)

        grid = linspace_timesteps(num_steps).numpy()
        interp = np.linspace(0.0, 1.0, jump_length + 1, dtype=np.float32)
        index = 0
        for i in range(num_steps):
            for j in range(num_resample_steps):
                # the sub-grid in float32, as the JAX package computes it
                r = grid[i] + interp * (grid[i + 1] - grid[i])
                x = x_t
                for k in range(jump_length):
                    known_s, _ = self.q_step_from_x_0(known, t_full(r[k + 1]), noise=draw("known", index, k))
                    unknown_s = self.p_step(x, t_full(r[k]), t_full(r[k + 1]), mode="ddpm",
                                            noise=draw("reverse", index, k), condition=condition)
                    x = mask * known_s + (1 - mask) * unknown_s
                x_s = x
                if i < num_steps - 1 and j < num_resample_steps - 1:
                    for k in range(jump_length, 0, -1):
                        x = self.q_step(x, t_full(r[k - 1]), t_full(r[k]), noise=draw("forward", index, k))
                x_t = x
                index += 1
        return x_s

    @torch.inference_mode()
    def repaint(
        self,
        known: torch.Tensor,
        mask: torch.Tensor,
        num_steps: int,
        num_resample_steps: int = 1,
        jump_length: int = 1,
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        draw: Callable[[str, int, int], torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """RePaint inpainting of ``known`` (B, *sampling_shape) where
        ``mask`` is 1, from ``x_T`` (drawn from ``generator`` when not
        given); see :meth:`repaint_loop`."""
        x = self.start(known.shape[0], x_T, generator)
        return self.repaint_loop(x, known, mask, num_steps, num_resample_steps, jump_length, generator, draw)

    inpaint = repaint
