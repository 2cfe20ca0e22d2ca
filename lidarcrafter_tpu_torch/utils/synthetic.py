"""Synthetic structured range images for training smoke runs and the
training gate of ``chip_smoke.py``.

Port of the JAX package's ``utils/synthetic.py`` (the distribution that its
``bench.py::bench_solver_cert`` trains on), drawn from a
``torch.Generator`` instead of a JAX key.
"""

from __future__ import annotations

import math

import torch


def banded_range_image_batch(
    batch: int,
    H: int,
    W: int,
    generator: torch.Generator | None = None,
    freq_levels: int = 4,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """(B, H, W, 2) banded sinusoidal depth + correlated reflectance, both
    in [-1, 1]: per-sample random phase and integer frequency
    (1..freq_levels) over the azimuth axis, depth attenuated toward the
    lower rows, reflectance = 0.5·depth + noise.  Draws phase, frequency,
    then noise from ``generator``."""
    kw = dict(generator=generator, device=device)
    phase = torch.rand((batch, 1, 1), **kw) * 2 * math.pi
    freq = 1.0 + torch.randint(0, freq_levels, (batch, 1, 1), **kw).float()
    cols = torch.arange(W, device=device)[None, None, :] / W
    rows = torch.arange(H, device=device)[None, :, None] / H
    depth = 0.6 * torch.sin(2 * math.pi * freq * cols + phase) * (1 - 0.5 * rows)
    refl = torch.clamp(0.5 * depth + 0.1 * torch.randn((batch, H, W), **kw), -1, 1)
    return torch.stack([depth, refl], dim=-1)
