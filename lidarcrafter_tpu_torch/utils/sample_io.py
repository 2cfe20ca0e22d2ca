"""Sample files for the metric CLIs: point lists and ``.pth`` range-image
dumps.

Copy of the JAX package's ``utils/sample_io.py`` (host numpy): the
reference's eval pipeline saves each generated frame as a torch ``.pth``
tensor of shape (5, H, W) = [depth, x, y, z, reflectance] and scores dumps
by masking depth to (0.5, 63.0) and flattening the masked xyz into a point
cloud.  This module reads those dumps and ``.txt`` / ``.npy`` / ``.bin``
point files, and writes dumps in that format.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# cf. evaluate_from_samples.py:19-21
MIN_DEPTH = 0.5
MAX_DEPTH = 63.0


def _nearest_exact_chw(img: np.ndarray, size) -> np.ndarray:
    """(C, H, W) 'nearest-exact' resize; matches
    ``F.interpolate(mode="nearest-exact")``: index = floor((i + 0.5)·scale)."""
    C, H, W = img.shape
    out_h, out_w = size
    rows = np.clip(
        np.floor((np.arange(out_h) + 0.5) * (H / out_h)).astype(np.int64), 0, H - 1
    )
    cols = np.clip(
        np.floor((np.arange(out_w) + 0.5) * (W / out_w)).astype(np.int64), 0, W - 1
    )
    return img[:, rows][:, :, cols]


def load_pth_image(path) -> np.ndarray:
    """One reference dump → float32 (C, H, W) numpy array (C ≥ 4:
    depth, x, y, z[, reflectance])."""
    img = torch.load(path, map_location="cpu")
    return np.asarray(img.detach().float().numpy(), np.float32)


def pth_to_points(
    img: np.ndarray,
    resolution=None,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
    keep_zeros: bool = False,
) -> np.ndarray:
    """Range-image dump → (N, 4) [x y z reflectance] point cloud with the
    reference's depth masking (``evaluate_from_samples.py:33-37``): points
    whose channel-0 depth falls outside (min_depth, max_depth) are zeroed.

    ``resolution``: optional (H, W) nearest-exact resize before masking (the
    reference resizes the REAL arm to the model resolution, ``:93-96``; dumps
    are usually already at model resolution).  ``keep_zeros=False`` drops the
    zeroed points — our point files store only valid returns (cf.
    ``tools/generate_cond.py``), and all-at-origin padding points would bias
    the BEV histograms against .bin-loaded real clouds.
    """
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[0] < 4:
        raise ValueError(f"expected (C>=4, H, W) range-image dump, got {img.shape}")
    if resolution is not None and tuple(img.shape[1:]) != tuple(resolution):
        img = _nearest_exact_chw(img, resolution)
    depth = img[0]
    mask = (depth > min_depth) & (depth < max_depth)
    xyz = np.transpose(img[1:4] * mask[None], (1, 2, 0)).reshape(-1, 3)
    if img.shape[0] > 4:
        refl = (img[4] * mask).reshape(-1, 1)
    else:
        refl = np.zeros((xyz.shape[0], 1), np.float32)
    pts = np.concatenate([xyz, refl], axis=1).astype(np.float32)
    if keep_zeros:
        return pts
    return pts[mask.reshape(-1)]


def load_pth_points(path, **kw) -> np.ndarray:
    return pth_to_points(load_pth_image(path), **kw)


def save_pth_sample(path, depth, xyz, reflectance=None) -> None:
    """Write ONE frame in the reference dump format: torch-saved (5, H, W)
    [depth, x, y, z, reflectance] float tensor
    (``sample_and_save_cond.py:119-160``).  Inputs are (H, W[, 1]) arrays
    in metric units (``postprocess_sample`` output)."""
    def chw(a, c):
        a = np.asarray(a, np.float32)
        if a.ndim == 2:
            a = a[..., None]
        return np.transpose(a, (2, 0, 1))[:c]

    H, W = np.asarray(depth).shape[:2]
    refl = (
        chw(reflectance, 1)
        if reflectance is not None
        else np.zeros((1, H, W), np.float32)
    )
    img = np.concatenate([chw(depth, 1), chw(xyz, 3), refl], axis=0)
    torch.save(torch.from_numpy(img), str(path))


def load_point_file(f, point_dims: int = 5) -> np.ndarray:
    """Dispatch one sample file → (N, >=3) float32 points.
    ``.txt``/``.npy`` raw point lists, ``.bin`` packed float32 rows of
    ``point_dims``, ``.pth`` reference range-image dumps."""
    f = Path(f)
    if f.suffix == ".npy":
        return np.load(f).astype(np.float32)
    if f.suffix == ".txt":
        return np.loadtxt(f).astype(np.float32)
    if f.suffix == ".pth":
        return load_pth_points(f)
    return np.fromfile(f, np.float32).reshape(-1, point_dims)[:, :4]


def list_sample_files(d, limit=None) -> list:
    """Sorted sample files in a dump directory (.txt/.npy/.bin/.pth)."""
    files = []
    for pat in ("*.txt", "*.npy", "*.bin", "*.pth"):
        files += sorted(Path(d).glob(pat))
    return files[:limit] if limit else files
