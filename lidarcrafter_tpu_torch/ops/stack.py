"""Stacked (variable-length) point-cloud ops.

Port of the JAX package's ``ops/stack.py`` (upstream's ``pointnet2_stack``):
a flat stacked cloud with per-batch counts becomes the padded batch layout
(a fixed max count and a mask) once, and the batched ops of ``points.py``
do the work; the voxel query and vector pooling of Voxel R-CNN / PV-RCNN++
work on the flat rows.
"""

from __future__ import annotations

import torch

from . import points as P

QUERY_CHUNK = 32768  # voxel_query's queries at a time: Voxel R-CNN pools 768 RoIs × 216 grid points a level


def _offsets(batch_cnt: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(batch_cnt, 0) - batch_cnt


def stack_to_padded(flat: torch.Tensor, batch_cnt: torch.Tensor, max_count: int):
    """(N_total, C) and (B,) counts → ((B, max_count, C), mask)."""
    idx = _offsets(batch_cnt)[:, None] + torch.arange(max_count, device=flat.device)
    mask = torch.arange(max_count, device=flat.device)[None] < batch_cnt[:, None]
    out = flat[idx.clamp(0, flat.shape[0] - 1)]
    return torch.where(mask.reshape(*mask.shape, *([1] * (out.ndim - 2))), out, 0), mask


def padded_to_stack(padded: torch.Tensor, mask: torch.Tensor, total: int) -> torch.Tensor:
    """The inverse of :func:`stack_to_padded`: padded rows dropped, order kept."""
    B, M = mask.shape
    flat_mask = mask.reshape(-1)
    pos = torch.where(flat_mask, torch.cumsum(flat_mask, 0) - 1, total)
    out = padded.new_zeros((total + 1, *padded.shape[2:]))
    out[pos] = padded.reshape(B * M, *padded.shape[2:])
    return out[:total]


def stack_ball_query(new_xyz, new_xyz_batch_cnt, xyz, xyz_batch_cnt, radius: float, nsample: int,
                     max_count: int = 4096) -> torch.Tensor:
    """Ball query per batch; neighbour indices into the flat ``xyz``."""
    xyz_p, xyz_m = stack_to_padded(xyz, xyz_batch_cnt, max_count)
    q_p, q_m = stack_to_padded(new_xyz, new_xyz_batch_cnt, max_count)
    idx = P.ball_query(q_p, xyz_p, radius, nsample, xyz_m) + _offsets(xyz_batch_cnt)[:, None, None].to(torch.int32)
    return padded_to_stack(idx, q_m, new_xyz.shape[0])


def stack_farthest_point_sampling(xyz, xyz_batch_cnt, num_samples: int, max_count: int = 4096) -> torch.Tensor:
    """FPS per batch of the stacked cloud; flat indices (B·num_samples,)."""
    xyz_p, xyz_m = stack_to_padded(xyz, xyz_batch_cnt, max_count)
    idx = P.farthest_point_sampling(xyz_p, num_samples, xyz_m)
    return (idx + _offsets(xyz_batch_cnt)[:, None].to(torch.int32)).reshape(-1)


def stack_three_nn(unknown, unknown_batch_cnt, known, known_batch_cnt, max_count: int = 4096):
    """The 3 nearest known points of each unknown point: (distances, flat
    indices), each (N_unknown, 3)."""
    k_p, k_m = stack_to_padded(known, known_batch_cnt, max_count)
    u_p, u_m = stack_to_padded(unknown, unknown_batch_cnt, max_count)
    dist, idx = P.three_nn(u_p, k_p, k_m)
    idx = idx + _offsets(known_batch_cnt)[:, None, None].to(torch.int32)
    total = unknown.shape[0]
    return padded_to_stack(dist, u_m, total), padded_to_stack(idx, u_m, total)


def voxel_indices_grid(coords_bzyx: torch.Tensor, grid_shape, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 4) [b, z, y, x] voxel coordinates → a dense (B, Z, Y, X) int32
    grid of their rows (-1: empty), the voxel query's index grid."""
    N = coords_bzyx.shape[0]
    B, Z, Y, X = grid_shape
    c = coords_bzyx.to(torch.int64)
    inb = ((c[:, 0] >= 0) & (c[:, 0] < B) & (c[:, 1] >= 0) & (c[:, 1] < Z)
           & (c[:, 2] >= 0) & (c[:, 2] < Y) & (c[:, 3] >= 0) & (c[:, 3] < X))
    if mask is not None:
        inb &= mask
    flat = torch.where(inb, ((c[:, 0] * Z + c[:, 1]) * Y + c[:, 2]) * X + c[:, 3], B * Z * Y * X)
    grid = torch.full((B * Z * Y * X + 1,), -1, dtype=torch.int32, device=coords_bzyx.device)
    grid[flat] = torch.arange(N, dtype=torch.int32, device=coords_bzyx.device)
    return grid[:-1].reshape(B, Z, Y, X)


def voxel_query(new_coords_bzyx: torch.Tensor, new_xyz: torch.Tensor, xyz: torch.Tensor,
                point_indices: torch.Tensor, query_range=(1, 1, 1), radius: float = 1.0, nsample: int = 16,
                new_mask: torch.Tensor | None = None):
    """Voxel-window ball query (upstream's ``voxel_query_gpu.cu``): each
    query scans the (2zr+1)(2yr+1)(2xr+1) voxels around its coordinate in
    dz, dy, dx order and keeps the first ``nsample`` rows within ``radius``;
    an empty window fills with row 0 and sets ``empty``, slots past the
    hits repeat the first hit.  Queries go ``QUERY_CHUNK`` at a time.  Returns
    (idx (M, nsample) int32 rows of ``xyz``, empty (M,))."""
    M = new_coords_bzyx.shape[0]
    dev = new_xyz.device
    if new_mask is None:
        new_mask = torch.ones(M, dtype=torch.bool, device=dev)
    B, Z, Y, X = point_indices.shape
    zr, yr, xr = query_range
    offs = torch.tensor([(dz, dy, dx) for dz in range(-zr, zr + 1) for dy in range(-yr, yr + 1)
                         for dx in range(-xr, xr + 1)], dtype=torch.int64, device=dev)
    flat_grid = point_indices.reshape(-1)
    idx_out, empty_out = [], []
    for s in range(0, M, QUERY_CHUNK):
        coords = new_coords_bzyx[s:s + QUERY_CHUNK].to(torch.int64)
        c = coords[:, None, 1:] + offs[None]
        m = new_mask[s:s + QUERY_CHUNK]
        inb = ((c[..., 0] >= 0) & (c[..., 0] < Z) & (c[..., 1] >= 0) & (c[..., 1] < Y)
               & (c[..., 2] >= 0) & (c[..., 2] < X) & m[:, None])
        flat = ((coords[:, 0, None] * Z + c[..., 0]) * Y + c[..., 1]) * X + c[..., 2]
        nbr = torch.where(inb, flat_grid[flat.clamp(min=0, max=flat_grid.numel() - 1)], -1).long()
        d2 = ((xyz[nbr.clamp(min=0)] - new_xyz[s:s + QUERY_CHUNK, None, :]) ** 2).sum(-1)
        valid = (nbr >= 0) & (d2 <= radius * radius) & inb
        cnt = torch.cumsum(valid, 1)
        slot = torch.where(valid & (cnt <= nsample), cnt - 1, nsample)
        first = nbr.gather(1, torch.argmax(valid.to(torch.int8), 1, keepdim=True))[:, 0]
        empty = ~valid.any(1)
        out = torch.where(empty, 0, first)[:, None].expand(-1, nsample + 1).clone()
        out.scatter_(1, slot, torch.where(slot < nsample, nbr, out[:, :1]))
        idx_out.append(out[:, :nsample].to(torch.int32))
        empty_out.append(empty)
    return torch.cat(idx_out), torch.cat(empty_out)


def vector_pool(support_xyz, support_feats, support_mask, new_xyz, new_mask, num_grid=(3, 3, 3),
                max_neighbour_distance: float = 1.0, num_c_each: int = 8, use_xyz: bool = True,
                neighbor_type: int = 0, nsample: int = -1, chunk: int = 256):
    """PV-RCNN++ vector pooling (upstream's ``vector_pool_kernel_stack``):
    each centre's cube [-d, d]³ splits into gx·gy·gz sub-voxels, and the
    neighbours (the cube for ``neighbor_type`` 0, the ball for 1; the first
    ``nsample`` in point order when > 0) average their features, channels
    folded modulo ``num_c_each``, per sub-voxel.  Returns (features (M,
    G·num_c_each), local xyz (M, G·3), point counts (M, G))."""
    gx, gy, gz = num_grid
    G = gx * gy * gz
    d = max_neighbour_distance
    N, C = support_feats.shape
    folded = torch.where(support_mask[:, None], support_feats.reshape(N, C // num_c_each, num_c_each).sum(1), 0.0)
    gsx, gsy, gsz = 2 * d / gx, 2 * d / gy, 2 * d / gz
    feats_o, lxyz_o, cnt_o = [], [], []
    for s in range(0, new_xyz.shape[0], chunk):
        nx, nm = new_xyz[s:s + chunk], new_mask[s:s + chunk]
        Mb = nx.shape[0]
        local = support_xyz[None] - nx[:, None]
        near = (local**2).sum(-1) <= d * d if neighbor_type == 1 else (local.abs() <= d).all(-1)
        near = near & support_mask[None] & nm[:, None]
        if nsample > 0:
            near = near & (torch.cumsum(near, 1) <= nsample)
        gi = (torch.floor((local[..., 0] + d) / gsx).to(torch.int64) * (gy * gz)
              + torch.floor((local[..., 1] + d) / gsy).to(torch.int64) * gz
              + torch.floor((local[..., 2] + d) / gsz).to(torch.int64)).clamp(0, G - 1)
        seg = torch.where(near, torch.arange(Mb, device=nx.device)[:, None] * G + gi, Mb * G).reshape(-1)
        w = near.reshape(-1, 1).to(folded.dtype)
        sums = folded.new_zeros(Mb * G + 1, num_c_each).index_add_(0, seg, folded.repeat(Mb, 1) * w)[:-1]
        cnts = folded.new_zeros(Mb * G + 1).index_add_(0, seg, w[:, 0])[:-1]
        lxyz = folded.new_zeros(Mb * G + 1, 3).index_add_(0, seg, (local * near[..., None]).reshape(-1, 3))[:-1]
        norm = torch.clamp(cnts, min=1e-6)[:, None]
        feats_o.append((sums / norm).reshape(Mb, G * num_c_each))
        lxyz_o.append(((lxyz / norm) if use_xyz else lxyz).reshape(Mb, G * 3))
        cnt_o.append(cnts.reshape(Mb, G))
    return torch.cat(feats_o), torch.cat(lxyz_o), torch.cat(cnt_o)
