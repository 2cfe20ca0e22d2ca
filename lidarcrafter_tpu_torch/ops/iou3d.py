"""Rotated BEV / 3D box IoU and NMS.

Port of the JAX package's ``ops/iou3d.py`` (upstream's ``iou3d_nms``): each
box pair's intersection is the first box's rectangle clipped by the four
half-planes of the second (Sutherland–Hodgman over a fixed 8-vertex buffer
with a vertex count), batched over all pairs with no data-dependent shapes.
NMS is the greedy suppression in descending score.  Boxes are (N, 7)
``[x, y, z, dx, dy, dz, heading]``, z at the centre.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_VERTICES = 8  # a rectangle clipped by a rectangle has at most 8 vertices


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) → (N, 4, 2) counter-clockwise corners in the BEV plane."""
    sx = boxes.new_tensor([0.5, -0.5, -0.5, 0.5])
    sy = boxes.new_tensor([0.5, 0.5, -0.5, -0.5])
    cx = boxes[:, 3:4] * sx
    cy = boxes[:, 4:5] * sy
    c, s = torch.cos(boxes[:, 6:7]), torch.sin(boxes[:, 6:7])
    return torch.stack([cx * c - cy * s + boxes[:, 0:1], cx * s + cy * c + boxes[:, 1:2]], dim=-1)


def _clip_by_halfplane(poly: torch.Tensor, count: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Clip the (P, 8, 2) convex polygons with (P,) vertex counts by the
    half-planes left of the (P, 2) edges a → b."""
    P = poly.shape[0]
    idx = torch.arange(MAX_VERTICES, device=poly.device).expand(P, -1)
    nxt = torch.gather(poly, 1, torch.where(idx + 1 < count[:, None], idx + 1, 0)[..., None].expand(-1, -1, 2))
    edge = (b - a)[:, None]

    def side(p):
        return edge[..., 0] * (p[..., 1] - a[:, None, 1]) - edge[..., 1] * (p[..., 0] - a[:, None, 0])

    s_cur, s_nxt = side(poly), side(nxt)
    cur_in, nxt_in = s_cur >= 0, s_nxt >= 0
    denom = s_cur - s_nxt
    t = s_cur / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    inter = poly + t[..., None] * (nxt - poly)
    valid = idx < count[:, None]
    # emissions per directed edge cur → nxt: [inter] where it crosses, then nxt where it is inside
    emit1 = valid & (nxt_in != cur_in)
    emit2 = valid & nxt_in
    counts = emit1.long() + emit2.long()
    base = torch.cumsum(counts, dim=1) - counts
    out = poly.new_zeros((P, MAX_VERTICES + 1, 2))  # the last slot takes the dropped writes
    pos1 = torch.where(emit1, base, MAX_VERTICES)
    pos2 = torch.where(emit2, base + emit1.long(), MAX_VERTICES)
    out.scatter_(1, pos1[..., None].expand(-1, -1, 2), inter)
    out.scatter_(1, pos2[..., None].expand(-1, -1, 2), nxt)
    return out[:, :MAX_VERTICES], counts.sum(dim=1)


def _polygon_area(poly: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Shoelace over the first ``count`` vertices of each (8, 2) polygon."""
    idx = torch.arange(MAX_VERTICES, device=poly.device).expand(poly.shape[0], -1)
    nxt = torch.gather(poly, 1, torch.where(idx + 1 < count[:, None], idx + 1, 0)[..., None].expand(-1, -1, 2))
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    return 0.5 * torch.where(idx < count[:, None], cross, 0.0).sum(dim=1).abs()


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) × (M, 7) → (N, M) BEV intersection areas."""
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    ca = box_corners_bev(boxes_a)[:, None].expand(N, M, 4, 2).reshape(N * M, 4, 2)
    cb = box_corners_bev(boxes_b)[None].expand(N, M, 4, 2).reshape(N * M, 4, 2)
    poly = torch.cat([ca, ca.new_zeros((N * M, MAX_VERTICES - 4, 2))], dim=1)
    count = torch.full((N * M,), 4, dtype=torch.long, device=boxes_a.device)
    for i in range(4):
        poly, count = _clip_by_halfplane(poly, count, cb[:, i], cb[:, (i + 1) % 4])
    return _polygon_area(poly, count).reshape(N, M)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) × (M, 7) → (N, M) rotated BEV IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def _height_overlap(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    a_max, a_min = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None], (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    b_max, b_min = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None], (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None]
    return torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) × (M, 7) → (N, M) rotated 3D IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b) * _height_overlap(boxes_a, boxes_b)
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None]
    return overlap / torch.clamp(vol_a + vol_b - overlap, min=1e-6)


def _pair_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) × (N, 7) → (N,) BEV intersection of aligned pairs."""
    ca, cb = box_corners_bev(boxes_a), box_corners_bev(boxes_b)
    poly = torch.cat([ca, ca.new_zeros((ca.shape[0], MAX_VERTICES - 4, 2))], dim=1)
    count = torch.full((ca.shape[0],), 4, dtype=torch.long, device=boxes_a.device)
    for i in range(4):
        poly, count = _clip_by_halfplane(poly, count, cb[:, i], cb[:, (i + 1) % 4])
    return _polygon_area(poly, count)


def paired_boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Row-wise 3D IoU of aligned box pairs, (N,)."""
    a_max, a_min = boxes_a[:, 2] + boxes_a[:, 5] / 2, boxes_a[:, 2] - boxes_a[:, 5] / 2
    b_max, b_min = boxes_b[:, 2] + boxes_b[:, 5] / 2, boxes_b[:, 2] - boxes_b[:, 5] / 2
    o3d = _pair_overlap_bev(boxes_a, boxes_b) * torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min),
                                                            min=0)
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return o3d / torch.clamp(vol_a + vol_b - o3d, min=1e-6)


def iou_bev_axis_aligned(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """BEV IoU that ignores the heading, (N, M)."""
    def span(b, i, j):
        return b[:, i] - b[:, j] / 2, b[:, i] + b[:, j] / 2

    ax1, ax2 = span(boxes_a, 0, 3)
    ay1, ay2 = span(boxes_a, 1, 4)
    bx1, bx2 = span(boxes_b, 0, 3)
    by1, by2 = span(boxes_b, 1, 4)
    iw = torch.clamp(torch.minimum(ax2[:, None], bx2[None]) - torch.maximum(ax1[:, None], bx1[None]), min=0)
    ih = torch.clamp(torch.minimum(ay2[:, None], by2[None]) - torch.maximum(ay1[:, None], by1[None]), min=0)
    inter = iw * ih
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float, box_mask: torch.Tensor | None = None,
        normal: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated NMS (``normal``: axis-aligned).  Returns ``(order,
    keep)``: the boxes in descending score (a stable sort, so equal scores
    keep their index order, as the JAX ``argsort`` does; masked boxes last)
    and a keep mask in that order.  The IoUs are computed on the boxes'
    device; the greedy scan, one row at a time, reads them on the host."""
    N = boxes.shape[0]
    if box_mask is None:
        box_mask = torch.ones(N, dtype=torch.bool, device=boxes.device)
    order = torch.sort(-torch.where(box_mask, scores, -torch.inf), stable=True).indices
    sorted_boxes = boxes[order]
    iou = (iou_bev_axis_aligned if normal else boxes_iou_bev)(sorted_boxes, sorted_boxes)
    over = torch.triu(iou > thresh, diagonal=1).cpu().numpy()
    live = box_mask[order].cpu().numpy().copy()
    keep = np.zeros(N, bool)
    for i in range(N):
        if live[i]:
            keep[i] = True
            live &= ~over[i]
    return order, torch.as_tensor(keep, device=boxes.device)
