"""Noise schedules: log-SNR schedules for continuous-time Gaussian
diffusion and beta tables for discrete-time DDPM.

Port of the JAX package's ``diffusion/schedules.py``: pure functions of the
timestep tensor with no broadcasting dims baked in, and float64 numpy beta
tables.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import numpy as np
import torch


def _log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.log(torch.clamp(t, min=eps))


def log_snr_schedule_linear(t: torch.Tensor) -> torch.Tensor:
    return -_log(torch.expm1(1e-4 + 10 * (t**2)))


def log_snr_schedule_cosine(
    t: torch.Tensor, logsnr_min: float = -15.0, logsnr_max: float = 15.0
) -> torch.Tensor:
    t_min = math.atan(math.exp(-0.5 * logsnr_max))
    t_max = math.atan(math.exp(-0.5 * logsnr_min))
    return -2.0 * _log(torch.tan(t_min + t * (t_max - t_min)))


def log_snr_schedule_cosine_shifted(
    t: torch.Tensor,
    image_d: float,
    noise_d: float,
    logsnr_min: float = -15.0,
    logsnr_max: float = 15.0,
) -> torch.Tensor:
    log_snr = log_snr_schedule_cosine(t, logsnr_min, logsnr_max)
    return log_snr + 2.0 * math.log(noise_d / image_d)


def log_snr_schedule_cosine_interpolated(
    t: torch.Tensor,
    image_d: float,
    noise_d_low: float,
    noise_d_high: float,
    logsnr_min: float = -15.0,
    logsnr_max: float = 15.0,
) -> torch.Tensor:
    lo = log_snr_schedule_cosine_shifted(t, image_d, noise_d_low, logsnr_min, logsnr_max)
    hi = log_snr_schedule_cosine_shifted(t, image_d, noise_d_high, logsnr_min, logsnr_max)
    return t * lo + (1 - t) * hi


def log_snr_to_alpha_sigma(log_snr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    alpha = torch.sqrt(1.0 / (1.0 + torch.exp(-log_snr)))
    sigma = torch.sqrt(1.0 / (1.0 + torch.exp(log_snr)))
    return alpha, sigma


def get_log_snr_fn(
    noise_schedule: str,
    image_d: float | None = None,
    noise_d_low: float | None = None,
    noise_d_high: float | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    if noise_schedule == "linear":
        return log_snr_schedule_linear
    if noise_schedule == "cosine":
        return log_snr_schedule_cosine
    if noise_schedule == "cosine_shifted":
        if image_d is None or noise_d_low is None:
            raise ValueError("cosine_shifted needs image_d and noise_d_low")
        return partial(
            log_snr_schedule_cosine_shifted, image_d=image_d, noise_d=noise_d_low
        )
    if noise_schedule == "cosine_interpolated":
        if None in (image_d, noise_d_low, noise_d_high):
            raise ValueError("cosine_interpolated needs image_d, noise_d_low, noise_d_high")
        return partial(
            log_snr_schedule_cosine_interpolated,
            image_d=image_d,
            noise_d_low=noise_d_low,
            noise_d_high=noise_d_high,
        )
    raise ValueError(f"invalid noise schedule: {noise_schedule}")


# ---------------------------------------------------------------- discrete
# Beta tables depend only on the step count, so they are computed on the
# host in numpy float64, as the reference's torch.float64 tables are.


def beta_schedule_linear(T: int) -> np.ndarray:
    """DDPM linear betas, scaled by 1000 / T."""
    scale = 1000.0 / T
    return np.linspace(scale * 0.0001, scale * 0.02, T, dtype=np.float64)


def beta_schedule_cosine(T: int, s: float = 0.008) -> np.ndarray:
    """Improved-DDPM cosine alpha-bar, as betas clipped to [0, 0.999]."""
    t = np.linspace(0, T, T + 1, dtype=np.float64) / T
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def beta_schedule_sigmoid(T: int, start: float = -3, end: float = 3, tau: float = 1.0) -> np.ndarray:
    """Sigmoid alpha-bar between ``start`` and ``end``, as betas clipped to
    [0, 0.999]."""
    t = np.linspace(0, T, T + 1, dtype=np.float64) / T
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    v_start = sig(start / tau)
    v_end = sig(end / tau)
    alphas_cumprod = (-sig((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)
