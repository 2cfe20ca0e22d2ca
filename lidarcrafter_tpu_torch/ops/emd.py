"""Approximate Earth Mover's Distance by the auction algorithm, on the
clouds' device.

Port of the JAX package's ``ops/emd.py`` (which re-designs upstream's CUDA
auction, ``emd_cuda.cu``): each iteration, every unassigned point of
``xyz1`` bids for its best target of ``xyz2``, the highest bid wins (the
smallest bidder on a tie, not an atomic race), evicted owners bid again and
prices rise; the last iteration assigns every unassigned point to its best
target.  The bidding values come in row chunks, so the (n, n) distance
matrix is never built, with distances in the matmul form
|a|² + |b|² − 2a·b, as in the JAX package.

Both clouds are (B, N, D) with equal N.  Returns squared distances (B, N)
and the assignment of each ``xyz1`` point (not a bijection when the auction
stops before it completes).
"""

from __future__ import annotations

import torch


def _row_top2(x1, sq1, x2t, sq2, price, chunk):
    """Per row i: the top two of 3 − ‖x1ᵢ − x2ⱼ‖ − priceⱼ (equal when the
    best is tied, as ``lax.top_k`` gives them) and the first best j."""
    top1, top2, best = [], [], []
    for start in range(0, x1.shape[1], chunk):
        rows = slice(start, start + chunk)
        d2 = (sq1[:, rows, None] + sq2[:, None, :]).sub_(torch.bmm(x1[:, rows], x2t).mul_(2.0))
        value = d2.clamp_(min=0.0).sqrt_().neg_().add_(3.0).sub_(price[:, None, :])  # (3 - ‖·‖) - price
        v, i = value.max(dim=2)  # the first index of the maximum
        top1.append(v)
        best.append(i)
        top2.append(value.scatter_(2, i[..., None], float("-inf")).amax(dim=2))
    return torch.cat(top1, 1), torch.cat(top2, 1), torch.cat(best, 1)


def emd_auction(
    xyz1: torch.Tensor,
    xyz2: torch.Tensor,
    eps: float = 0.005,
    iters: int = 50,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, D) × (B, N, D) → (dist² (B, N), assignment (B, N) int64)."""
    if xyz1.shape != xyz2.shape:
        raise ValueError(f"emd_auction needs clouds of one shape, got {tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    B, n, _ = xyz1.shape
    dev = xyz1.device
    sq1 = (xyz1 * xyz1).sum(-1)
    sq2 = (xyz2 * xyz2).sum(-1)
    x2t = xyz2.transpose(1, 2)
    k_ids = torch.arange(n, device=dev).expand(B, n)
    assignment = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    assignment_inv = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((B, n), dtype=xyz1.dtype, device=dev)
    for it in range(iters):
        unass = assignment < 0
        top1, top2, best_k = _row_top2(xyz1, sq1, x2t, sq2, price, chunk)
        if it == iters - 1:
            assignment = torch.where(unass, best_k, assignment)
            break
        bid_inc = torch.where(unass, top1 - top2 + eps, float("-inf"))
        # segment n collects the bids of assigned rows, which bid nothing
        seg = torch.where(unass, best_k, n)
        max_inc = torch.full((B, n + 1), float("-inf"), dtype=bid_inc.dtype, device=dev)
        max_inc = max_inc.scatter_reduce_(1, seg, bid_inc, "amax")[:, :n]
        has = max_inc > float("-inf")
        # deterministic winner: the smallest row achieving the highest bid
        hit = unass & (bid_inc >= torch.gather(max_inc, 1, best_k))
        cand = torch.where(hit, k_ids, n)
        winner = torch.full((B, n + 1), n, dtype=torch.int64, device=dev)
        winner = winner.scatter_reduce_(1, seg, cand, "amin")[:, :n]
        winner = torch.where(has, winner, n)
        # evict the previous owners of won targets, then seat the winners
        owners = torch.where(has & (assignment_inv >= 0), assignment_inv, n)
        a = torch.cat([assignment, assignment.new_full((B, 1), -1)], 1)
        a.scatter_(1, owners, -1)
        a.scatter_(1, winner, k_ids)
        assignment = a[:, :n]
        assignment_inv = torch.where(has, winner, assignment_inv)
        price = price + torch.where(has, max_inc.clamp(min=0.0), 0.0)
    assignment = assignment.clamp(0, n - 1)
    matched = torch.gather(xyz2, 1, assignment[..., None].expand_as(xyz2))
    return ((xyz1 - matched) ** 2).sum(-1), assignment


def emd_metric(
    xyz1: torch.Tensor,
    xyz2: torch.Tensor,
    eps: float = 0.005,
    iters: int = 50,
    chunk: int = 1024,
) -> torch.Tensor:
    """The eval suite's scalar EMD: the mean over points of
    sqrt(dist²); a 0-dim tensor on the clouds' device."""
    d2, _ = emd_auction(xyz1, xyz2, eps=eps, iters=iters, chunk=chunk)
    return torch.sqrt(d2.clamp(min=0.0)).mean()
