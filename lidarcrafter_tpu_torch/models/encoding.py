"""Spatial coordinate encodings (spherical harmonics / polar / Fourier
features), numpy only.

Copy of the JAX package's ``models/encoding.py``.  The encodings depend on static config only, so they are computed on
the host in float64 and handed to the model as a constant buffer.
"""

from __future__ import annotations

import math

import numpy as np


def generate_polar_coords(H: int, W: int) -> np.ndarray:
    """(H, W, 2): [phi (polar), theta (azimuth)]."""
    phi = (0.5 - np.arange(H, dtype=np.float32) / H) * np.pi
    theta = (1 - np.arange(W, dtype=np.float32) / W) * 2 * np.pi - np.pi
    phi, theta = np.meshgrid(phi, theta, indexing="ij")
    return np.stack([phi, theta], axis=-1)


def spherical_harmonics_components(directions: np.ndarray, levels: int) -> np.ndarray:
    """Real SH basis values up to ``levels`` (at most 5).

    ``directions``: (..., 3) unit vectors → (..., levels**2).
    """
    x = directions[..., 0]
    y = directions[..., 1]
    z = directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [np.full(x.shape, 0.28209479177387814, dtype=directions.dtype)]
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if levels > 4:
        comps += [
            2.5033429417967046 * x * y * (xx - yy),
            1.7701307697799304 * y * z * (3 * xx - yy),
            0.9461746957575601 * x * y * (7 * zz - 1),
            0.6690465435572892 * y * z * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * x * z * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * x * z * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return np.stack(comps, axis=-1)


def spherical_harmonics_encoding(coords: np.ndarray, levels: int = 5) -> np.ndarray:
    """(H, W, 2) [phi, theta] → (H, W, levels**2): the basis at the unit
    direction of each (elevation, azimuth)."""
    phi, theta = coords[..., 0], coords[..., 1]
    directions = np.stack(
        [
            np.cos(theta) * np.cos(phi),
            -np.sin(theta) * np.cos(phi),
            np.sin(phi),
        ],
        axis=-1,
    )
    return spherical_harmonics_components(directions, levels)


def fourier_feature_frequencies(resolution: tuple[int, int]) -> np.ndarray:
    """Frequency bank (2, L_h + L_w) for axis-separable Fourier features."""
    L_h = int(math.ceil(math.log2(resolution[0])))
    L_w = int(math.ceil(math.log2(resolution[1])))
    freqs_h = np.concatenate([np.exp2(np.arange(L_h)), np.zeros(L_w)])
    freqs_w = np.concatenate([np.zeros(L_h), np.exp2(np.arange(L_w))])
    return np.stack([freqs_h, freqs_w], axis=0).astype(np.float32)


def fourier_features_encoding(
    coords: np.ndarray, resolution: tuple[int, int]
) -> np.ndarray:
    """(H, W, 2) coords → (H, W, 2 * (L_h + L_w))."""
    freqs = fourier_feature_frequencies(resolution).astype(np.float64)
    proj = np.einsum("hwc,cf->hwf", coords.astype(np.float64), freqs)
    out = np.concatenate([np.sin(proj), np.cos(proj)], axis=-1)
    return out.astype(np.float32)


def coords_encoding_channels(kind: str | None, resolution: tuple[int, int]) -> int:
    """Extra input channels contributed by each encoding kind."""
    if kind is None:
        return 0
    if kind == "spherical_harmonics":
        return 25  # levels=5
    if kind == "polar_coordinates":
        return 2
    if kind == "fourier_features":
        L_h = int(math.ceil(math.log2(resolution[0])))
        L_w = int(math.ceil(math.log2(resolution[1])))
        return 2 * (L_h + L_w)
    raise ValueError(kind)


def encode_coords(
    coords: np.ndarray, kind: str | None, resolution: tuple[int, int]
) -> np.ndarray | None:
    """Dispatch; coords is (H, W, 2) [elevation/phi, azimuth/theta]."""
    if kind is None:
        return None
    if kind == "spherical_harmonics":
        return spherical_harmonics_encoding(coords, levels=5)
    if kind == "polar_coordinates":
        return coords
    if kind == "fourier_features":
        return fourier_features_encoding(coords, resolution)
    raise ValueError(kind)
