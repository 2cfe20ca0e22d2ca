"""Scene-graph condition encoder (tri-partite GCN).

Port of the JAX package's ``models/scene_graph.py::SceneGraph``: class and
predicate embeddings concatenated with precomputed CLIP text features, an
encoder GCN, the graph edits (nodes in ``added_mask`` get a zero latent;
added and manipulated nodes get a change noise) and a manipulation GCN.

The graph comes as one flat node axis over all scenes of a batch:
``objs`` (N,) class ids, ``triples`` (T, 3) (subject, predicate, object)
with node indices into that axis, ``text_feats`` (N, 512) and
``rel_feats`` (T, 512) CLIP features, and optional (N,) bool
``added_mask`` / ``manipulated_mask`` and (T,) bool ``edge_mask``.

The change noise is ``noise`` when given, else drawn from ``generator``
(under data parallelism at the global node batch's size, with this rank's
``noise_rows`` kept), else zeros (the JAX package's ``rng=None``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..draws import Rows
from .graph import GraphTripleConvNet


class SceneGraph(nn.Module):
    def __init__(
        self,
        num_objs: int = 9,
        num_preds: int = 16,
        embedding_dim: int = 64,
        gconv_pooling: str = "avg",
        gconv_num_layers: int = 5,
        mlp_normalization: str = "none",
        separated: bool = False,
        replace_latent: bool = False,
        residual: bool = False,
        use_angles: bool = False,
        use_clip: bool = True,
    ):
        super().__init__()
        E = self.embedding_dim = embedding_dim
        self.replace_latent, self.use_clip = replace_latent, use_clip
        add_dim = 512 if use_clip else 0
        out_dim = 2 * E + add_dim
        self.obj_embeddings_ec = nn.Embedding(num_objs + 1, 2 * E)
        self.pred_embeddings_ec = nn.Embedding(num_preds, 2 * E)
        self.pred_embeddings_man_dc = nn.Embedding(num_preds, 2 * E)
        gcn = dict(hidden_dim=4 * E, pooling=gconv_pooling, mlp_normalization=mlp_normalization,
                   residual=residual)
        self.gconv_net_ec = GraphTripleConvNet(
            out_dim, out_dim, num_layers=gconv_num_layers, output_dim=out_dim, **gcn)
        self.gconv_net_manipulation = GraphTripleConvNet(
            out_dim + E + 2 * E + add_dim, 2 * E + add_dim, num_layers=min(gconv_num_layers, 5),
            output_dim=out_dim, **gcn)

    def _embed(self, objs, p, text_feats, rel_feats, pred_embeddings):
        obj_embed, pred_embed = self.obj_embeddings_ec(objs), pred_embeddings(p)
        if self.use_clip:
            obj_embed = torch.cat([text_feats, obj_embed], dim=1)
            pred_embed = torch.cat([rel_feats, pred_embed], dim=1)
        return obj_embed, pred_embed

    def forward(
        self,
        objs: torch.Tensor,
        triples: torch.Tensor,
        text_feats: torch.Tensor,
        rel_feats: torch.Tensor,
        added_mask: torch.Tensor | None = None,
        manipulated_mask: torch.Tensor | None = None,
        edge_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
        use_running_average: bool = True,
        noise_rows: Rows | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (latent_obj_vecs (N, 2E+512), obj_embed_ (N, 512+2E))."""
        N, E = objs.shape[0], self.embedding_dim
        p = triples[:, 1]
        edges = triples[:, [0, 2]]
        no = torch.zeros((N,), dtype=torch.bool, device=objs.device)
        added_mask = no if added_mask is None else added_mask
        manipulated_mask = no if manipulated_mask is None else manipulated_mask

        obj_embed, pred_embed = self._embed(objs, p, text_feats, rel_feats, self.pred_embeddings_ec)
        latent_obj, _ = self.gconv_net_ec(obj_embed, pred_embed, edges, edge_mask, use_running_average)

        # graph edits
        latent_obj = torch.where(added_mask[:, None], 0.0, latent_obj)
        touched = (added_mask | manipulated_mask)[:, None]
        if noise is None and generator is not None:
            noise = (noise_rows or Rows.whole(N)).randn(generator, objs.device, (E,), latent_obj.dtype)
        change = latent_obj.new_zeros((N, E)) if noise is None else torch.where(touched, noise, 0.0)
        latent_in = torch.cat([latent_obj, change], dim=1)

        obj_embed_, pred_embed_ = self._embed(objs, p, text_feats, rel_feats, self.pred_embeddings_man_dc)
        latent_man, _ = self.gconv_net_manipulation(
            torch.cat([latent_in, obj_embed_], dim=1), pred_embed_, edges, edge_mask, use_running_average)
        latent_out = latent_man if self.replace_latent else torch.where(touched, latent_man, latent_obj)
        return latent_out, obj_embed_
