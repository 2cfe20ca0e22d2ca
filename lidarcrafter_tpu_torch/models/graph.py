"""Scene-graph triple convolutions over a flat, padded node batch.

Port of the JAX package's ``models/graph.py``: ``MaskedBatchNorm``,
``MLP``, ``GraphTripleConv`` and ``GraphTripleConvNet``.  A graph arrives
as (N, D) node vectors, (T, D) predicate vectors, (T, 2) edges into the
flat node axis and a (T,) edge mask.  The message pooling is the JAX
package's masked ``segment_sum`` into N + 1 segments: one ``index_add_``
into an (N + 1)-row buffer, masked triples routed to its last row, which
is dropped.  On the card ``index_add_`` adds in no fixed order, so pooled
messages may differ from the CPU's in the last bits.

``mlp_normalization='batch'`` uses :class:`MaskedBatchNorm`: serving reads
the running statistics (``use_running_average=True``); the batch-statistics
path, which also updates them, is the one a trainer runs.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows only.  Carries just the JAX
    package's state: ``weight`` / ``bias`` (flax ``scale`` / ``bias``) and
    the ``running_mean`` / ``running_var`` buffers (flax ``batch_stats``
    ``mean`` / ``var``)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None, use_running_average: bool = True
    ) -> torch.Tensor:
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                mean = x.mean(dim=0)
                var = (x - mean).square().mean(dim=0)
            else:
                m = mask.to(x.dtype)[:, None]
                n = torch.clamp(m.sum(), min=1.0)
                mean = (x * m).sum(dim=0) / n
                var = ((x - mean).square() * m).sum(dim=0) / n
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean.detach())
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var.detach())
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class MLP(nn.Module):
    """Linear (+ masked BN) (+ ReLU) per layer; layers ``lin{i}`` /
    ``bn{i}`` as in flax."""

    def __init__(
        self, in_dim: int, dims: Sequence[int], batch_norm: str = "none", final_nonlinearity: bool = True
    ):
        super().__init__()
        self.n, self.final_nonlinearity = len(dims), final_nonlinearity
        for i, d in enumerate(dims):
            self.add_module(f"lin{i}", nn.Linear(in_dim, d))
            if batch_norm == "batch" and (i < self.n - 1 or final_nonlinearity):
                self.add_module(f"bn{i}", MaskedBatchNorm(d))
            in_dim = d

    def forward(self, x: torch.Tensor, mask=None, use_running_average: bool = True) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"lin{i}")(x)
            if i < self.n - 1 or self.final_nonlinearity:
                bn = getattr(self, f"bn{i}", None)
                if bn is not None:
                    x = bn(x, mask, use_running_average)
                x = torch.relu(x)
        return x


class GraphTripleConv(nn.Module):
    """One scene-graph conv layer: an MLP over each (subject, predicate,
    object) triple, the subject and object messages averaged (or summed)
    per node, an MLP over the pooled vectors, optional residual
    projections.  ``forward(obj_vecs (N, Do), pred_vecs (T, Dp), edges (T, 2),
    edge_mask (T,) | None)`` returns ((N, Dout), (T, Dp))."""

    def __init__(
        self,
        input_dim_obj: int,
        input_dim_pred: int,
        output_dim: int,
        hidden_dim: int = 512,
        pooling: str = "avg",
        mlp_normalization: str = "none",
        residual: bool = False,
    ):
        super().__init__()
        if pooling not in ("avg", "sum"):
            raise NotImplementedError(pooling)
        H, Dp = hidden_dim, input_dim_pred
        self.hidden_dim, self.input_dim_pred, self.pooling = H, Dp, pooling
        self.net1 = MLP(2 * input_dim_obj + Dp, (H, 2 * H + Dp), batch_norm=mlp_normalization)
        self.net2 = MLP(H, (H, output_dim), batch_norm=mlp_normalization)
        self.residual = residual
        if residual:
            self.linear_projection = nn.Linear(input_dim_obj, output_dim)
            self.linear_projection_pred = nn.Linear(Dp, Dp)

    def forward(self, obj_vecs, pred_vecs, edges, edge_mask=None, use_running_average: bool = True):
        N, T = obj_vecs.shape[0], pred_vecs.shape[0]
        H, Dp = self.hidden_dim, self.input_dim_pred
        if edge_mask is None:
            edge_mask = torch.ones((T,), dtype=torch.bool, device=obj_vecs.device)
        s_idx, o_idx = edges[:, 0], edges[:, 1]
        cur_t = torch.cat([obj_vecs[s_idx], pred_vecs, obj_vecs[o_idx]], dim=1)
        new_t = self.net1(cur_t, edge_mask, use_running_average)
        new_s, new_p, new_o = new_t[:, :H], new_t[:, H:H + Dp], new_t[:, H + Dp:]

        # segment sums into N + 1 rows, masked triples in the last
        em = edge_mask.to(obj_vecs.dtype)[:, None]
        trash = torch.full_like(s_idx, N)
        seg = torch.cat([torch.where(edge_mask, s_idx, trash), torch.where(edge_mask, o_idx, trash)])
        pooled = obj_vecs.new_zeros((N + 1, H)).index_add_(0, seg, torch.cat([new_s, new_o]) * em.repeat(2, 1))[:N]
        if self.pooling == "avg":
            counts = obj_vecs.new_zeros((N + 1,)).index_add_(0, seg, em[:, 0].repeat(2))[:N]
            pooled = pooled / torch.clamp(counts, min=1.0)[:, None]

        node_mask = torch.ones((N,), dtype=torch.bool, device=obj_vecs.device)
        new_obj = self.net2(pooled, node_mask, use_running_average)
        if self.residual:
            new_obj = new_obj + self.linear_projection(obj_vecs)
            new_p = new_p + self.linear_projection_pred(pred_vecs)
        return new_obj, new_p


class GraphTripleConvNet(nn.Module):
    """``num_layers`` graph convs ``gconv{i}``; every layer keeps the node
    width but the last, which maps to ``output_dim`` when given."""

    def __init__(
        self,
        input_dim_obj: int,
        input_dim_pred: int,
        num_layers: int = 2,
        hidden_dim: int = 512,
        residual: bool = False,
        pooling: str = "avg",
        mlp_normalization: str = "none",
        output_dim: int | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = output_dim is not None and i >= num_layers - 1
            self.add_module(f"gconv{i}", GraphTripleConv(
                input_dim_obj, input_dim_pred, output_dim if last else input_dim_obj, hidden_dim=hidden_dim,
                pooling=pooling, mlp_normalization=mlp_normalization, residual=residual,
            ))

    def forward(self, obj_vecs, pred_vecs, edges, edge_mask=None, use_running_average: bool = True):
        for i in range(self.num_layers):
            obj_vecs, pred_vecs = getattr(self, f"gconv{i}")(
                obj_vecs, pred_vecs, edges, edge_mask, use_running_average)
        return obj_vecs, pred_vecs
