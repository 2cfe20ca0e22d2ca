"""Rendering for train-time previews (NHWC tensors, on the tensor's device).

Port of the JAX package's ``utils/render.py``: BEV point-cloud splatting
through a bilinear scatter-add rasterizer, surface normals of a
coordinated range image (rows padded by their edge, columns wrapped round
the azimuth ring) and colormap colorizing.
"""

from __future__ import annotations

import numpy as np
import torch


def make_Rt(roll=0.0, pitch=0.0, yaw=0.0, x=0.0, y=0.0, z=0.0, device: str | torch.device = "cpu"):
    """Extrinsics (yaw, then pitch, then roll): R (1, 3, 3), t (1, 3)."""

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        if axis == "x":
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == "y":
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = rot("z", yaw) @ rot("y", pitch) @ rot("x", roll)
    return (torch.as_tensor(R[None], dtype=torch.float32, device=device),
            torch.tensor([[x, y, z]], dtype=torch.float32, device=device))


def bilinear_rasterizer(coords: torch.Tensor, values: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """Splat (B, N, C) ``values`` at float (B, N, 2) (row, column)
    ``coords`` onto their four neighbouring pixels, with bilinear weights
    (a weight below 1e-3 dropped); returns (B, H, W, C)."""
    B, N, C = values.shape
    H, W = out_shape
    h, w = coords[..., 0], coords[..., 1]
    h_t = torch.floor(h)
    h_b = h_t + 1
    w_l = torch.floor(w)
    w_r = w_l + 1
    h_t_s, h_b_s = torch.clamp(h_t, 0, H - 1), torch.clamp(h_b, 0, H - 1)
    w_l_s, w_r_s = torch.clamp(w_l, 0, W - 1), torch.clamp(w_r, 0, W - 1)
    wt_ht = (h_b - h) * (h_t == h_t_s)
    wt_hb = (h - h_t) * (h_b == h_b_s)
    wt_wl = (w_r - w) * (w_l == w_l_s)
    wt_wr = (w - w_l) * (w_r == w_r_s)

    out = values.new_zeros((B, H * W, C))
    for wt, hh, ww in ((wt_ht * wt_wl, h_t_s, w_l_s), (wt_ht * wt_wr, h_t_s, w_r_s),
                       (wt_hb * wt_wl, h_b_s, w_l_s), (wt_hb * wt_wr, h_b_s, w_r_s)):
        wt = wt * (wt >= 1e-3)
        idx = (ww + W * hh).to(torch.int64)
        out.scatter_add_(1, idx[..., None].expand(-1, -1, C), values * wt[..., None])
    return out.reshape(B, H, W, C)


def render_point_clouds(points: torch.Tensor, colors: torch.Tensor | None = None, size: int = 800,
                        R: torch.Tensor | None = None, t: torch.Tensor | None = None,
                        focal_length: float = 1.0) -> torch.Tensor:
    """BEV splat of (B, N, 3) clouds → (B, size, size, 3): z flipped,
    extrinsics applied, a pinhole at the image centre, weights exp(−3·depth)
    normalised per pixel."""
    points = points.clone()
    points[..., 2] *= -1
    B, N, _ = points.shape
    if colors is None:
        colors = points.new_ones((B, N, 3))
    if R is not None:
        points = points @ R
    if t is not None:
        points = points + t
    z = points[..., 2:3]
    uv = points[..., :2] * focal_length / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z) + 0.5
    uv = uv * size
    mask = ((0 < uv) & (uv < size - 1)).all(dim=-1, keepdim=True)
    colors = colors * mask
    uv = size - uv
    depth = torch.linalg.norm(points, dim=-1, keepdim=True)
    weight = torch.exp(-3.0 * depth) * (depth > 1e-8)
    bev = bilinear_rasterizer(uv, weight * colors, (size, size))
    norm = bilinear_rasterizer(uv, weight, (size, size))
    return bev / (norm + 1e-8)


_OFFSETS = ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1))


def estimate_surface_normal(points: torch.Tensor, d: int = 2, mode: str = "closest") -> torch.Tensor:
    """Unit surface normals of a coordinated range image (B, H, W, 3): cross
    products of the vectors to neighbour pairs ``d`` pixels away, the pair
    closest to the anchor (``closest``) or the mean over the 8 (``mean``)."""
    B, H, W, _ = points.shape
    dev = points.device
    rows = torch.clamp(torch.arange(-d, H + d, device=dev), 0, H - 1)  # edge padding
    cols = torch.arange(-d, W + d, device=dev) % W  # the azimuth ring
    p = points[:, rows][:, :, cols]
    hh = torch.arange(H, device=dev) + d
    ww = torch.arange(W, device=dev) + d
    anchors = p[:, hh[:, None], ww[None, :]]

    def neigh(k):
        dh, dw = _OFFSETS[k][0] * d, _OFFSETS[k][1] * d
        return p[:, (hh + dh)[:, None], (ww + dw)[None, :]]

    p1 = torch.stack([neigh(k) for k in range(8)], dim=1)  # (B, 8, H, W, 3)
    p2 = torch.stack([neigh((k + 2) % 8) for k in range(8)], dim=1)
    if mode == "closest":
        diff = torch.linalg.norm(p1 - anchors[:, None], dim=-1) + torch.linalg.norm(p2 - anchors[:, None], dim=-1)
        i = torch.argmin(diff, dim=1)[:, None, ..., None].expand(-1, -1, -1, -1, 3)
        v1 = torch.gather(p1, 1, i)[:, 0] - anchors
        v2 = torch.gather(p2, 1, i)[:, 0] - anchors
        normals = torch.linalg.cross(v1, v2, dim=-1)
    elif mode == "mean":
        normals = torch.linalg.cross(p1 - anchors[:, None], p2 - anchors[:, None], dim=-1).mean(dim=1)
    else:
        raise NotImplementedError(mode)
    return normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-8)


_TURBO = None


def _turbo_colors() -> np.ndarray:
    """matplotlib's turbo at 256 levels, or a grey ramp without matplotlib."""
    global _TURBO
    if _TURBO is None:
        try:
            import matplotlib.cm as cm

            _TURBO = np.asarray(cm.turbo(np.linspace(0, 1, 256))[:, :3], np.float32)
        except Exception:
            g = np.linspace(0, 1, 256, dtype=np.float32)
            _TURBO = np.stack([g, g, g], axis=1)
    return _TURBO


def colorize(tensor: torch.Tensor, colors: np.ndarray | None = None) -> torch.Tensor:
    """(B, H, W[, 1]) values in [0, 1] → (B, H, W, 3) colormapped."""
    colors = torch.as_tensor(colors if colors is not None else _turbo_colors(), device=tensor.device)
    if tensor.ndim == 4:
        tensor = tensor[..., 0]
    ids = torch.clamp((tensor * 256).to(torch.int32), 0, 255).to(torch.int64)
    return colors[ids]
