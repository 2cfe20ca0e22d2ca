"""Sparse 3D voxel convolutions over a padded voxel table.

Port of the JAX package's ``ops/sparse.py``, the ground of the FSVD / FPVD
backbones (MinkowskiNet, SPVCNN) and of the voxel detectors.  Voxels live in
a (V, C) table of V rows, the padded voxel budget, with (V, 3) int32
coordinates and a (V,) validity mask.  A neighbour is found by a binary
search (``torch.searchsorted``) over the sorted keys of the table's
coordinates, and each kernel tap is one gather followed by one
(V, Cin) × (Cin, Cout) product; here the taps' gathers are stacked so that
one (V, taps·Cin) × (taps·Cin, Cout) product does them all.

Keys.  The JAX package compares (hi, lo) int32 pairs lexicographically,
hi = x and lo = y·2¹⁵ + z (computed in int32), with y and z in
[-2¹⁵, 2¹⁵) so that the ±1-cell offsets of the taps stay injective.  The
port packs the same pair into one int64, ``hi·2³² + (lo + 2³¹)``: lo + 2³¹
lies in [0, 2³²), so the packing is a bijection that keeps the pair's
lexicographic order, and a lower bound over it is the JAX lower bound.  An
invalid row carries the pair (2³¹−1, 2³¹−1), the largest key, so it sorts
last, as in JAX.

Which voxel wins.  :func:`voxelize` keeps the first point of each voxel
(torchsparse's ``sparse_quantize``): a stable sort over the keys puts a
voxel's points in index order, and the slots are the voxels in key order.
When a cloud has more voxels than the budget, the voxels past the budget in
key order are dropped, as in JAX.

Every voxel index comes from a true division (:func:`~.projection.div`),
never a multiply by the reciprocal, so the card and the CPU put a point in
the same cell.  Scatter means (``index_add_``) sum in an order the card does
not fix; hold them with a tolerance.
"""

from __future__ import annotations

import torch

from .projection import div

LO_BASE = 1 << 15
KEY_MAX = (1 << 31) - 1  # the int32 sentinel of an invalid row, in hi and in lo
_SENTINEL = (KEY_MAX << 32) + (KEY_MAX + (1 << 31))  # its packed key: the largest int64


def coords_key(coords: torch.Tensor) -> torch.Tensor:
    """(V, 3) int coordinates → (V,) int64 keys in the (hi, lo) pair's order."""
    c = coords.to(torch.int32)
    lo = c[:, 1] * LO_BASE + c[:, 2]  # int32, wrapping as the JAX package's does
    return (c[:, 0].long() << 32) + (lo.long() + (1 << 31))


def masked_keys(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Keys with the largest key on the rows that ``mask`` leaves out."""
    return torch.where(mask, coords_key(coords), torch.full_like(mask, _SENTINEL, dtype=torch.long))


def sorted_key_table(coords: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, their rows in the table) for :func:`lookup`."""
    keys, order = torch.sort(masked_keys(coords, mask), stable=True)
    return keys, order


def lookup(table: tuple[torch.Tensor, torch.Tensor], query: torch.Tensor, query_mask: torch.Tensor) -> torch.Tensor:
    """Rows of the table whose keys equal ``query`` (any shape), or -1; a
    query that ``query_mask`` leaves out finds nothing."""
    keys, order = table
    pos = torch.searchsorted(keys, query.reshape(-1)).reshape(query.shape)
    posc = pos.clamp(max=keys.numel() - 1)
    hit = (pos < keys.numel()) & (keys[posc] == query) & query_mask
    return torch.where(hit, order[posc], -1)


def _unique_sites(keys: torch.Tensor, sites: torch.Tensor, max_voxels: int):
    """The distinct valid keys among ``keys`` (sentinel = not a site) in key
    order: (slot of each row in the sorted order, the sort's order, whether
    the row is the first of its site, the (max_voxels, 3) site table, its
    mask).  Slots run from 0; the sites past
    ``max_voxels`` are dropped, so every row of the table below the count is
    written."""
    skeys, order = torch.sort(keys, stable=True)
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    first &= skeys != _SENTINEL
    slot = torch.cumsum(first, 0) - 1
    n = first.sum()
    mask = torch.arange(max_voxels, device=keys.device) < n
    table = torch.zeros((max_voxels + 1, 3), dtype=torch.int32, device=keys.device)
    write = torch.where(first, slot, max_voxels).clamp(max=max_voxels)
    table[write] = sites[order].to(torch.int32)  # the non-first and the overflow rows land in the spare row
    return slot, order, first, table[:max_voxels], mask


def voxelize(points: torch.Tensor, voxel_size: float, point_mask: torch.Tensor | None = None,
             max_voxels: int = 65536):
    """Quantize a padded cloud to unique voxels, the first point of each
    voxel winning.  Returns (coords (max_voxels, 3) int32, the source point
    of each voxel (max_voxels,) int32, voxel mask, inverse (N,) point →
    voxel slot; slots past the budget and padded points point at the last
    slot)."""
    N = points.shape[0]
    if point_mask is None:
        point_mask = torch.ones(N, dtype=torch.bool, device=points.device)
    vox = torch.floor(div(points[:, :3], voxel_size)).to(torch.int32)
    big = torch.full_like(vox, 2**30)
    vox = vox - torch.where(point_mask[:, None], vox, big).amin(0)
    slot, order, first, coords, vmask = _unique_sites(masked_keys(vox, point_mask), vox, max_voxels)
    src = torch.zeros(max_voxels + 1, dtype=torch.int32, device=points.device)
    write = torch.where(first & (slot < max_voxels), slot, max_voxels)
    src[write] = order.to(torch.int32)
    inv = torch.empty(N, dtype=torch.int32, device=points.device)
    inv[order] = slot.clamp(max=max_voxels - 1).to(torch.int32)
    inv = torch.where(point_mask, inv, max_voxels - 1)
    return coords, src[:max_voxels], vmask, inv


def _tap_offsets(k, device) -> torch.Tensor:
    """(∏k, 3) offsets 0..k-1 per axis in ij-meshgrid order (z fastest)."""
    axes = [torch.arange(n, device=device) for n in k]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3).to(torch.int32)


def _gather_taps(features: torch.Tensor, voxel_mask: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(V, Cin) features at the (Vq, T) neighbour rows (-1: none) → (Vq, T·Cin),
    zero where there is no neighbour or it is not valid."""
    V = features.shape[0]
    table = torch.cat([torch.where(voxel_mask[:, None], features, 0.0), features.new_zeros(1, features.shape[1])])
    return table[torch.where(nbr >= 0, nbr, V)].reshape(nbr.shape[0], -1)


def _conv_taps(features, voxel_mask, nbr, kernel):
    """Σ_t gathered_t · kernel[t] as one product; ``kernel`` (T, Cin, Cout)."""
    return _gather_taps(features, voxel_mask, nbr) @ kernel.reshape(-1, kernel.shape[-1])


def submanifold_conv3d(features: torch.Tensor, coords: torch.Tensor, voxel_mask: torch.Tensor,
                       kernel: torch.Tensor, bias: torch.Tensor | None = None, kernel_size: int = 3):
    """Submanifold sparse conv (stride 1, the output sites are the input
    sites).  ``features`` (V, Cin), ``coords`` (V, 3), ``kernel``
    (k³, Cin, Cout), taps in ij-meshgrid order."""
    r = kernel_size // 2
    offs = _tap_offsets((kernel_size,) * 3, coords.device) - r
    table = sorted_key_table(coords, voxel_mask)
    query = coords_key((coords[:, None, :] + offs[None]).reshape(-1, 3)).reshape(coords.shape[0], -1)
    nbr = lookup(table, query, voxel_mask[:, None])
    out = _conv_taps(features, voxel_mask, nbr, kernel)
    if bias is not None:
        out = out + bias
    return torch.where(voxel_mask[:, None], out, 0.0)


def _strided_out(features, coords, voxel_mask, kernel, sites_keys, sites, out_from_site, max_voxels):
    """The output site table of ``sites`` (keyed by ``sites_keys``), and the
    conv that gathers, for output site o and tap t, the input voxel
    ``out_from_site(o)[t]``."""
    _, _, _, out_coords, out_mask = _unique_sites(sites_keys, sites, max_voxels)
    table = sorted_key_table(coords, voxel_mask)
    src = out_from_site(out_coords)  # (max_voxels, T, 3)
    nbr = lookup(table, coords_key(src.reshape(-1, 3)).reshape(src.shape[:2]), out_mask[:, None])
    out = _conv_taps(features, voxel_mask, nbr, kernel)
    return torch.where(out_mask[:, None], out, 0.0), out_coords, out_mask


def sparse_downsample2(features: torch.Tensor, coords: torch.Tensor, voxel_mask: torch.Tensor,
                       kernel: torch.Tensor, max_voxels: int = 65536):
    """Stride-2 sparse conv of kernel 2³: the output sites are the unique
    ``coords // 2``, each gathering its up-to-8 children.  ``kernel``
    (8, Cin, Cout).  Returns (features, coords, mask) of the output."""
    parent = torch.div(coords, 2, rounding_mode="floor")
    offs = _tap_offsets((2, 2, 2), coords.device)
    return _strided_out(features, coords, voxel_mask, kernel, masked_keys(parent, voxel_mask), parent,
                        lambda oc: oc[:, None, :] * 2 + offs[None], max_voxels)


def voxelize_mean(points: torch.Tensor, feats: torch.Tensor, voxel_size: float,
                  point_mask: torch.Tensor | None = None, max_voxels: int = 65536):
    """Unique voxels with the mean of their points' features (torchsparse's
    ``initial_voxelize``).  Returns (voxel features (max_voxels, C), voxel
    coords, voxel mask, the points' float stride-1 voxel coordinates (N, 3),
    inverse (N,))."""
    N = points.shape[0]
    if point_mask is None:
        point_mask = torch.ones(N, dtype=torch.bool, device=points.device)
    p = div(points[:, :3], voxel_size)
    p = p - torch.floor(torch.where(point_mask[:, None], p, torch.inf).amin(0))
    coords, _, vmask, inv = voxelize(p, 1.0, point_mask=point_mask, max_voxels=max_voxels)
    idx = inv.long()
    sums = feats.new_zeros(max_voxels, feats.shape[1]).index_add_(0, idx, torch.where(point_mask[:, None], feats, 0.0))
    cnts = feats.new_zeros(max_voxels).index_add_(0, idx, point_mask.to(feats.dtype))
    vox = sums / torch.clamp(cnts, min=1.0)[:, None]
    return torch.where(vmask[:, None], vox, 0.0), coords, vmask, p, inv


def point_to_voxel_mean(pt_feats: torch.Tensor, pts_vox: torch.Tensor, point_mask: torch.Tensor,
                        vox_coords: torch.Tensor, vox_mask: torch.Tensor, level: int = 0):
    """Average point features into an existing level-``level`` voxel table
    (torchsparse's ``point_to_voxel``): a point falls in
    ``floor(p / 2**level)`` of its stride-1 voxel coordinates ``pts_vox``."""
    V = vox_coords.shape[0]
    pcoord = torch.floor(pts_vox / float(2**level)).to(torch.int32)  # a power of two: exact
    slot = lookup(sorted_key_table(vox_coords, vox_mask), coords_key(pcoord), point_mask)
    ok = slot >= 0
    idx = torch.where(ok, slot, V).long()
    sums = pt_feats.new_zeros(V + 1, pt_feats.shape[1]).index_add_(0, idx, torch.where(ok[:, None], pt_feats, 0.0))
    cnts = pt_feats.new_zeros(V + 1).index_add_(0, idx, ok.to(pt_feats.dtype))
    out = sums[:V] / torch.clamp(cnts[:V], min=1.0)[:, None]
    return torch.where(vox_mask[:, None], out, 0.0)


def voxel_to_point_trilinear(vox_feats: torch.Tensor, vox_coords: torch.Tensor, vox_mask: torch.Tensor,
                             pts_vox: torch.Tensor, point_mask: torch.Tensor, level: int = 0):
    """Trilinear devoxelisation (torchsparse's ``voxel_to_point`` with
    ``calc_ti_weights``): each point reads the corners ``floor(p/s) +
    {0,1}³`` of its level-``level`` coordinates with product weights of the
    fraction; absent corners weigh 0 and the rest are renormalised by their
    sum + 1e-8."""
    p = pts_vox / float(2**level)
    p0 = torch.floor(p)
    frac = p - p0
    p0 = p0.to(torch.int32)
    table = sorted_key_table(vox_coords, vox_mask)
    feats = torch.cat([torch.where(vox_mask[:, None], vox_feats, 0.0), vox_feats.new_zeros(1, vox_feats.shape[1])])
    V = vox_coords.shape[0]
    out = vox_feats.new_zeros(pts_vox.shape[0], vox_feats.shape[1])
    wsum = vox_feats.new_zeros(pts_vox.shape[0])
    for i in range(8):
        bits = ((i >> 2) & 1, (i >> 1) & 1, i & 1)
        w = [frac[:, a] if b else 1.0 - frac[:, a] for a, b in enumerate(bits)]
        w = w[0] * w[1] * w[2]
        corner = p0 + p0.new_tensor(bits)
        nbr = lookup(table, coords_key(corner), point_mask)
        w = w * (nbr >= 0)
        out = out + feats[torch.where(nbr >= 0, nbr, V)] * w[:, None]
        wsum = wsum + w
    out = out / (wsum + 1e-8)[:, None]
    return torch.where(point_mask[:, None], out, 0.0)


def sparse_upsample2(features: torch.Tensor, coords_coarse: torch.Tensor, coarse_mask: torch.Tensor,
                     coords_fine: torch.Tensor, fine_mask: torch.Tensor, kernel: torch.Tensor):
    """Stride-2 transposed sparse conv onto the stored fine sites: a fine
    site ``c`` reads its parent ``c // 2`` through tap ``c % 2`` (ij order).
    ``kernel`` (8, Cin, Cout)."""
    parent = torch.div(coords_fine, 2, rounding_mode="floor")
    nbr = lookup(sorted_key_table(coords_coarse, coarse_mask), coords_key(parent), fine_mask)
    gathered = _gather_taps(features, coarse_mask, nbr[:, None])
    off = coords_fine - parent * 2
    tap = ((off[:, 0] * 2 + off[:, 1]) * 2 + off[:, 2]).long()
    Cin, Cout = kernel.shape[1], kernel.shape[2]
    every = (gathered @ kernel.permute(1, 0, 2).reshape(Cin, -1)).view(-1, 8, Cout)  # each row through all 8 taps
    out = every.gather(1, tap[:, None, None].expand(-1, 1, Cout))[:, 0]
    return torch.where(fine_mask[:, None], out, 0.0)


def sparse_conv3d_strided(features: torch.Tensor, coords: torch.Tensor, voxel_mask: torch.Tensor,
                          kernel: torch.Tensor, kernel_size=(3, 3, 3), stride=(2, 2, 2), padding=(1, 1, 1),
                          max_voxels: int = 65536, out_spatial=None):
    """Regular strided sparse conv with spconv's output sites
    (``spconv.SparseConv3d``): every ``o`` with ``o·s − p + t = i`` for an
    active input ``i`` and a tap ``t`` in [0, k), bounded by the output
    grid ``(in + 2p − k)//s + 1`` when ``out_spatial`` (the input dims) is
    given.  ``kernel`` (∏k, Cin, Cout), taps in ij-meshgrid order.
    Returns (features, coords, mask) of the output."""
    k, s, p = kernel_size, stride, padding
    out_dims = None if out_spatial is None else [(out_spatial[a] + 2 * p[a] - k[a]) // s[a] + 1 for a in range(3)]

    def axis_cands(i, a):
        outs = []
        for t in range(k[a]):
            num = i + p[a] - t
            ok = (torch.remainder(num, s[a]) == 0) & (num >= 0)
            o = torch.div(num, s[a], rounding_mode="floor")
            if out_dims is not None:
                ok &= o < out_dims[a]
            outs.append((o, ok))
        return outs

    cands, cmask = [], []
    for cx, okx in axis_cands(coords[:, 0], 0):
        for cy, oky in axis_cands(coords[:, 1], 1):
            for cz, okz in axis_cands(coords[:, 2], 2):
                cands.append(torch.stack([cx, cy, cz], 1))
                cmask.append(okx & oky & okz & voxel_mask)
    cands, cmask = torch.cat(cands), torch.cat(cmask)
    offs = _tap_offsets(k, coords.device)
    svec = torch.tensor(s, dtype=torch.int32, device=coords.device)
    pvec = torch.tensor(p, dtype=torch.int32, device=coords.device)
    return _strided_out(features, coords, voxel_mask, kernel, masked_keys(cands, cmask), cands,
                        lambda oc: (oc * svec - pvec)[:, None, :] + offs[None], max_voxels)


def voxelize_coords_mean(coords_int: torch.Tensor, feats: torch.Tensor, point_mask: torch.Tensor,
                         max_voxels: int = 65536):
    """Unique voxels of pre-quantized int coordinates with the mean of their
    points' features (pcdet's MeanVFE on a fixed grid; no re-anchoring).
    Returns (voxel features (max_voxels, C), coords, mask)."""
    slot, order, _, coords, vmask = _unique_sites(masked_keys(coords_int, point_mask), coords_int, max_voxels)
    inv = torch.empty_like(slot)
    inv[order] = slot.clamp(max=max_voxels - 1)
    idx = torch.where(point_mask, inv, max_voxels)
    sums = feats.new_zeros(max_voxels + 1, feats.shape[1]).index_add_(0, idx,
                                                                     torch.where(point_mask[:, None], feats, 0.0))
    cnts = feats.new_zeros(max_voxels + 1).index_add_(0, idx, point_mask.to(feats.dtype))
    vox = sums[:max_voxels] / torch.clamp(cnts[:max_voxels], min=1.0)[:, None]
    return torch.where(vmask[:, None], vox, 0.0), coords, vmask
