"""Conditional continuous-time diffusion sampler.

Port of the sampling half of the JAX package's ``diffusion/conditional.py``
(``CondContinuousDiffusion``): the condition encoder runs once per
``sample`` call, then the shared reverse loop of ``continuous.py`` takes x_T
to x_0 with DDPM, DDIM or DPM-Solver++(2M).  Only the denoiser call differs
from the unconditional sampler: the model takes a condition dict.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch
from torch import nn

from ..precision import cast_tree
from .continuous import ContinuousDiffusion


@dataclasses.dataclass(kw_only=True)
class CondContinuousDiffusion(ContinuousDiffusion):
    """``model(x_t, {'time_condition', 'other_condition'})`` predicts eps /
    v / x_0; ``cond_model(batch_dict)`` returns ``other_condition``."""

    cond_model: nn.Module

    def get_network_condition(self, batch_dict: dict) -> dict:
        return dict(other_condition=self.cond_model(batch_dict))

    def denoise(self, x_t: torch.Tensor, log_snr_t: torch.Tensor, condition=None) -> torch.Tensor:
        """Image, time and the condition tree go in as ``dtype``; the
        prediction comes back float32."""
        cd = cast_tree(dict(condition), self.dtype)
        cd["time_condition"] = log_snr_t.to(self.dtype)
        return self.model(x_t.to(self.dtype), cd).float()

    @torch.inference_mode()
    def sample(
        self,
        batch_dict: dict,
        batch_size: int,
        num_steps: int,
        mode: Literal["ddpm", "ddim", "dpmpp_2m"] = "ddpm",
        ddim_eta: float = 0.0,
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Conditioned sampling from ``x_T`` (drawn from ``generator`` when
        not given); returns x_0 (B, H, W, C)."""
        x = self.start(batch_size, x_T, generator)
        condition = self.get_network_condition(batch_dict)
        return self.reverse(x, num_steps, mode, ddim_eta, generator, condition)
