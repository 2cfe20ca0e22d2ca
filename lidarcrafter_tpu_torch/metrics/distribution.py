"""Fréchet distance and squared MMD on feature sets.

Port of the JAX package's ``metrics/distribution.py``: tr sqrtm(Σ₁Σ₂) comes
from symmetric eigendecompositions (Σ₁Σ₂ is similar to Σ₁^½Σ₂Σ₁^½, which is
symmetric PSD, so the trace of its root is Σᵢ√λᵢ), in float64 on either
device.  With fewer samples than dimensions the covariances are
rank-deficient, and the clip of negative eigenvalues to 0 decides the
result.  The squared MMD runs in float64 too.
"""

from __future__ import annotations

import numpy as np
import torch


def _sym_sqrtm(mat: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh(mat)
    vals = torch.sqrt(vals.clamp(min=0.0))
    return (vecs * vals[None, :]) @ vecs.T


def trace_sqrt_product(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """tr sqrtm(Σ₁·Σ₂) for symmetric PSD Σ."""
    s1h = _sym_sqrtm(sigma1)
    vals = torch.linalg.eigvalsh(s1h @ sigma2 @ s1h)
    return torch.sqrt(vals.clamp(min=0.0)).sum()


def compute_frechet_distance(feats1, feats2, device: str | torch.device = "cuda") -> float:
    """Fréchet distance between the Gaussians fitted to two (N, F) feature
    sets (numpy or tensors), in float64 on ``device``."""
    feats1 = torch.as_tensor(feats1).to(device, torch.float64)
    feats2 = torch.as_tensor(feats2).to(device, torch.float64)
    mu1, mu2 = feats1.mean(0), feats2.mean(0)
    sigma1, sigma2 = torch.cov(feats1.T), torch.cov(feats2.T)
    m = ((mu1 - mu2) ** 2).sum()
    tr = trace_sqrt_product(sigma1, sigma2)
    return float(m + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr)


def compute_squared_mmd(
    feats1,
    feats2,
    num_subsets: int = 100,
    max_subset_size: int = 1000,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> float:
    """Polynomial-kernel subset MMD² of two (N, F) feature sets, in float64
    on ``device``: the estimate is a difference of cubed kernel sums, which
    float32 loses for features far from unit scale.  The subsets are drawn
    on the host as the JAX package draws them: ``RandomState(seed)``, x from
    ``feats2`` then y from ``feats1``, once per subset."""
    x_all = torch.as_tensor(feats2).to(device, torch.float64)
    y_all = torch.as_tensor(feats1).to(device, torch.float64)
    n = x_all.shape[1]
    m = min(min(y_all.shape[0], x_all.shape[0]), max_subset_size)
    rng = np.random.RandomState(seed)
    draws = np.stack([
        np.stack([rng.choice(x_all.shape[0], m, replace=False), rng.choice(y_all.shape[0], m, replace=False)])
        for _ in range(num_subsets)
    ])
    draws = torch.as_tensor(draws, device=x_all.device)
    terms = []
    for ix, iy in draws:
        x, y = x_all[ix], y_all[iy]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        terms.append((a.sum() - torch.trace(a)) / (m - 1) - b.sum() * 2 / m)
    return float(torch.stack(terms).sum()) / num_subsets / m
