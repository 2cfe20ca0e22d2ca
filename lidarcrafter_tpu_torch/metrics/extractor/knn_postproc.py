"""RangeNet kNN label clean-up: a vote over range-image neighbours.

Port of the JAX package's ``metrics/extractor/knn_postproc.py`` (upstream's
``postproc/KNN.py``): each point gathers the S×S window of the range image
at its pixel, weighs |range − neighbour range| by an inverted Gaussian,
takes the K nearest and votes their classes, a vote past the range cutoff
going to an invalid bin.  Each point gathers only its own window.
"""

from __future__ import annotations

import numpy as np
import torch


def inv_gaussian_window(search: int, sigma: float) -> np.ndarray:
    """1 − the normalised 2D Gaussian, flattened (S²,) float32."""
    coords = np.arange(search, dtype=np.float64)
    mean = (search - 1) / 2.0
    g = np.exp(-((coords[:, None] - mean) ** 2 + (coords[None, :] - mean) ** 2) / (2.0 * sigma**2))
    g = g / (2.0 * np.pi * sigma**2)
    g = g / g.sum()
    return (1.0 - g).reshape(-1).astype(np.float32)


def knn_postprocess(proj_range: torch.Tensor, unproj_range: torch.Tensor, proj_argmax: torch.Tensor,
                    px: torch.Tensor, py: torch.Tensor, knn: int = 5, search: int = 5, sigma: float = 1.0,
                    cutoff: float = 1.0, nclasses: int = 17) -> torch.Tensor:
    """(H, W) range and argmax images, per-point ranges and pixels →
    cleaned per-point labels (P,) int32 in [1, nclasses)."""
    H, W = proj_range.shape
    pad = (search - 1) // 2
    d = torch.arange(search, device=proj_range.device) - pad
    offs = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).reshape(-1, 2)  # unfold's row-major window
    ny = py.long()[:, None] + offs[None, :, 0]
    nx = px.long()[:, None] + offs[None, :, 1]
    inside = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
    nyc, nxc = ny.clamp(0, H - 1), nx.clamp(0, W - 1)
    nbr_range = torch.where(inside, proj_range[nyc, nxc], 0.0)  # unfold pads with zeros
    nbr_range = torch.where(nbr_range < 0, torch.inf, nbr_range)  # invalid ranges never win
    center = (search * search - 1) // 2
    nbr_range[:, center] = unproj_range
    dist = (nbr_range - unproj_range[:, None]).abs() * torch.as_tensor(inv_gaussian_window(search, sigma),
                                                                       device=proj_range.device)
    knn_d, idx = torch.sort(dist, dim=1, stable=True)  # the k smallest, ties to the lower index (top_k's)
    knn_d, idx = knn_d[:, :knn], idx[:, :knn]
    nbr_cls = torch.where(inside, proj_argmax[nyc, nxc], 0).long()
    knn_cls = nbr_cls.gather(1, idx)
    if cutoff > 0:
        knn_cls = torch.where(knn_d > cutoff, nclasses, knn_cls)
    votes = torch.zeros(knn_cls.shape[0], nclasses + 1, device=knn_cls.device).scatter_add_(
        1, knn_cls, torch.ones_like(knn_cls, dtype=torch.float32))
    # neither unlabeled (0) nor the cutoff bin
    return (torch.argmax(votes[:, 1:-1], dim=1) + 1).to(torch.int32)
