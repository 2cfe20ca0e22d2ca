"""Spherical range-image projection and box rasterisation.

Port of the JAX package's ``ops/projection.py``: a padded point cloud with a
validity mask becomes an (H, W, C+2) range image whose channels are
``[x, y, z, feat..., depth, valid]``, and 3D boxes become the layout
condition mask (class, centre depth) and the loss-weight map.  Everything
is fixed-shape tensor code, batched over any leading dims, with no host
sync: masks, one sort, gathers and a scatter to unique slots.

The operation order is the JAX package's (``depth + 1e-6``, ``floor(g·W)/W``
then ``·W`` and truncation, ``% 1`` on the azimuth, the rotations as
explicit multiply-adds), and every division by a constant is a true
division on every device (:func:`div`), so that a point lands in the same
pixel on the card and on the CPU unless it lies within an ulp of a pixel
edge.
"""

from __future__ import annotations

import math

import torch

def norm3(xyz: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last dim of (..., 3)."""
    x, y, z = xyz.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, rounded once on the CPU and on the card alike.

    On the card torch computes a tensor over a Python float as a multiply
    by the reciprocal, which can be an ulp off the quotient.  That is enough
    to move a whole row: the points of the z = 0 row have an elevation that
    lies exactly on a row edge, whatever the ego motion.  Dividing by a
    0-dim tensor on the operand's device keeps the true division.
    """
    return x / x.new_full((), c)


def spherical_grid_coords(
    xyz: torch.Tensor,
    H: int,
    W: int,
    fov_up: float = 10.0,
    fov_down: float = -30.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point grid row, grid column (int32) and depth of (..., N, 3)."""
    x, y, z = xyz.unbind(-1)
    depth = norm3(xyz)
    h_up, h_down = math.radians(fov_up), math.radians(fov_down)
    elevation = torch.arcsin(z / (depth + 1e-6)) + abs(h_down)
    grid_h = 1.0 - div(elevation, h_up - h_down)
    grid_h = torch.clamp(torch.floor(grid_h * H), 0, H - 1).to(torch.int32)
    azimuth = -torch.atan2(y, x)
    grid_w = ((div(azimuth, math.pi) + 1) / 2) % 1
    grid_w = torch.clamp(torch.floor(grid_w * W), 0, W - 1).to(torch.int32)
    return grid_h, grid_w, depth


def range_image_winners(
    pixel: torch.Tensor, depth: torch.Tensor, num_pixels: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The winning point of each pixel: the least depth, ties to the lowest
    point index.

    ``pixel`` (S, N) holds pixel ids in [0, num_pixels], ``num_pixels``
    marking padding; returns the (S, num_pixels) winner index (clipped to
    N - 1 where no point fell) and whether a point fell there.

    One stable sort on the key (pixel, depth) puts each pixel's winner at
    the start of its run: depth is not negative, so its float bits order as
    integers below the pixel id.  The run starts are scattered to their
    pixel and every other point to a slot of its own past the image, so all
    indices are unique (deterministic on the card) and the extra slots are
    sliced off.
    """
    S, N = pixel.shape
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    order = torch.sort((pixel.to(torch.int64) << 31) | bits, dim=-1, stable=True).indices
    pix_s = torch.gather(pixel.to(torch.int64), 1, order)
    run_start = torch.ones_like(pix_s, dtype=torch.bool)
    run_start[:, 1:] = pix_s[:, 1:] != pix_s[:, :-1]
    position = torch.arange(N, device=pixel.device).expand(S, N)
    slot = torch.where(run_start & (pix_s < num_pixels), pix_s, num_pixels + position)
    winner = torch.full((S, num_pixels + N), N, dtype=torch.int64, device=pixel.device)
    winner = winner.scatter_(1, slot, order)[:, :num_pixels]
    hit = winner < N
    return winner.clamp_(max=N - 1), hit


def points_to_range_image(
    points: torch.Tensor,
    point_mask: torch.Tensor | None = None,
    *,
    H: int = 32,
    W: int = 1024,
    min_depth: float = 1.45,
    max_depth: float = 80.0,
    fov_up: float = 10.0,
    fov_down: float = -30.0,
) -> torch.Tensor:
    """Project (..., N, C) points ``[x, y, z, feat...]`` with an (..., N)
    validity mask to (..., H, W, C+2) ``[x, y, z, feat..., depth, valid]``.

    Each pixel holds its real point of least depth (ties to the lowest
    index), or zeros; ``valid`` says whether that point's depth lies in
    [min_depth, max_depth] (out-of-range points still claim their pixel).
    """
    lead, (N, C) = points.shape[:-2], points.shape[-2:]
    points = points.reshape(-1, N, C)
    if point_mask is None:
        point_mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
    point_mask = point_mask.reshape(-1, N)
    grid_h, grid_w, depth = spherical_grid_coords(points[..., :3], H, W, fov_up, fov_down)
    in_range = (depth >= min_depth) & (depth <= max_depth)
    pixel = torch.where(point_mask, grid_h.to(torch.int64) * W + grid_w, H * W)
    winner, hit = range_image_winners(pixel, depth, H * W)
    feats = torch.cat([points, depth[..., None], in_range[..., None].to(points.dtype)], dim=-1)
    image = torch.gather(feats, 1, winner[..., None].expand(-1, -1, C + 2))
    image = image * hit[..., None].to(points.dtype)
    return image.reshape(*lead, H, W, C + 2)


def convert_points_to_2d(
    points: torch.Tensor,
    H: int = 32,
    W: int = 1024,
    fov_up: float = 10.0,
    fov_down: float = -30.0,
) -> torch.Tensor:
    """Normalised (grid_w, grid_h) image coords of (..., N, ≥3) points."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    depth = norm3(points[..., :3]) + 1e-6
    h_up, h_down = math.radians(fov_up), math.radians(fov_down)
    elevation = torch.arcsin(z / depth) + abs(h_down)
    grid_h = 1.0 - div(elevation, h_up - h_down)
    grid_h = div(torch.clamp(torch.floor(grid_h * H), 0, H - 1), H)
    azimuth = -torch.atan2(y, x)
    grid_w = ((div(azimuth, math.pi) + 1) / 2) % 1
    grid_w = div(torch.clamp(torch.floor(grid_w * W), 0, W - 1), W)
    return torch.stack([grid_w, grid_h], dim=-1)


def box_corners_3d(boxes_3d: torch.Tensor) -> torch.Tensor:
    """(..., N, ≥7) boxes ``[x, y, z, l, w, h, yaw, ...]`` → (..., N, 8, 3)
    corners, rotated by yaw about z and moved to the centre."""
    # the corners' offsets ±size/2 in the order (+ + +), (+ − +), (− − +),
    # (− + +), then the same at −h/2; built from the sizes, since a constant
    # tensor from the host would be a copy that waits for the card's queue
    hl, hw, hh = (boxes_3d[..., i : i + 1] * 0.5 for i in (3, 4, 5))
    cx = torch.cat([hl, hl, -hl, -hl] * 2, dim=-1)
    cy = torch.cat([hw, -hw, -hw, hw] * 2, dim=-1)
    cz = torch.cat([hh] * 4 + [-hh] * 4, dim=-1)
    yaw = boxes_3d[..., 6:7]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = (c * cx - s * cy) + boxes_3d[..., 0:1]
    y = (s * cx + c * cy) + boxes_3d[..., 1:2]
    z = cz + boxes_3d[..., 2:3]
    return torch.stack([x, y, z], dim=-1)


def convert_boxes_to_2d(
    boxes_3d: torch.Tensor,
    box_mask: torch.Tensor | None = None,
    *,
    H: int = 32,
    W: int = 1024,
    fov_up: float = 10.0,
    fov_down: float = -30.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterise (..., N, ≥8) boxes ``[x, y, z, l, w, h, yaw, class]``.

    Returns ``corners_2d (..., N, 4)`` (x1, y1, x2, y2 normalised),
    ``condition_mask (..., H, W, 2)`` (class, box-centre depth) and
    ``scene_loss_weight_map (..., H, W)``.  A box whose columns span more
    than 0.6 of the width straddles the azimuth seam and covers the columns
    outside its span; where boxes overlap, the later one wins.
    """
    lead, (N, D) = boxes_3d.shape[:-2], boxes_3d.shape[-2:]
    boxes = boxes_3d.reshape(-1, N, D)
    dev = boxes.device
    if box_mask is None:
        box_mask = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
    box_mask = box_mask.reshape(-1, N)

    c_depth = norm3(boxes[..., :3]) + 1e-6
    grid = convert_points_to_2d(box_corners_3d(boxes), H=H, W=W, fov_up=fov_up, fov_down=fov_down)
    x1, x2 = grid[..., 0].amin(-1), grid[..., 0].amax(-1)
    y1, y2 = grid[..., 1].amin(-1), grid[..., 1].amax(-1)
    corners_2d = torch.stack([x1, y1, x2, y2], dim=-1)

    xi1, xi2 = (x1 * W).to(torch.int32), (x2 * W).to(torch.int32)
    yi1, yi2 = (y1 * H).to(torch.int32), (y2 * H).to(torch.int32)
    wrap = (xi2 - xi1) / W > 0.6  # the box straddles the azimuth seam

    def box_axis(v):  # (S, N) → (S, N, 1, 1)
        return v[..., None, None]

    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    in_rows = (rows >= box_axis(yi1)) & (rows < box_axis(yi2))
    inside = (cols >= box_axis(xi1)) & (cols < box_axis(xi2))
    regions = in_rows & torch.where(box_axis(wrap), ~inside, inside) & box_axis(box_mask)  # (S, N, H, W)

    area_in = (xi2 - xi1) * (yi2 - yi1)
    area_wrap = (W - xi2 + xi1) * (yi2 - yi1)
    areas = torch.where(wrap, area_wrap, area_in).to(torch.float32) * box_mask

    sem = torch.zeros(regions.shape[:1] + regions.shape[2:], dtype=torch.float32, device=dev)
    dep = torch.zeros_like(sem)
    for i in range(N):  # sequential overwrite: later boxes win
        sem = torch.where(regions[:, i], box_axis(boxes[:, i, 7]), sem)
        dep = torch.where(regions[:, i], box_axis(c_depth[:, i]), dep)
    condition_mask = torch.stack([sem, dep], dim=-1)

    max_area = torch.clamp(areas.amax(-1, keepdim=True), min=1e-6)
    weights = (3.0 - areas / max_area) * box_mask
    weight_map = (regions.to(torch.float32) * box_axis(weights)).sum(1)
    return (
        corners_2d.reshape(*lead, N, 4),
        condition_mask.reshape(*lead, H, W, 2),
        torch.exp(weight_map).reshape(*lead, H, W),
    )
