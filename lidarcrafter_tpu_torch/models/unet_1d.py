"""1D UNet over the node axis for layout diffusion (``UNet1DModel``).

Port of the JAX package's ``models/unet_1d.py``.  Each scene-graph node is
a length-1 sequence, so every convolution is its middle tap (a Linear), the
up and down samplers are Linears, and the LDM cross-attention has one query
and one key: its softmax is 1 and it returns ``to_out(to_v(context))``.
``to_q`` and ``to_k`` exist for weight parity only.  Before the UNet, a
5-layer GCN over the box triples (``box_message_passing``) turns the noisy
boxes, the node embeddings and the time embedding into the (N, concat_dim)
cross-attention context.

Activations are (N, 1, C).  Every GroupNorm is the port's ``GroupNorm32``
(32 groups; eps 1e-5 in the residual blocks and the output, 1e-6 in the
transformer's ``norm``), so on the card each one is a launch of the
GroupNorm kernel with N one-row images: 56 a call at the published
topology (22 residual blocks × 2, 11 transformers, the output norm).

Inputs follow the flat node batch: ``box_t`` (N, in_channels) and
``cond_dict = {'time_condition': (N,) or (), 'other_condition': {'preds':
(T, 3), 'uc_b': (N, 512 + 2·gconv_dim), 'edge_mask': (T,) or None}}``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .graph import GraphTripleConvNet
from .ops import GroupNorm32


class ResBlock1D(nn.Module):
    """ADM residual block at sequence length 1."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 use_scale_shift_norm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = nn.Linear(in_channels, out_channels)
        self.emb_proj = nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels)
        self.out_norm = GroupNorm32(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = nn.Linear(out_channels, out_channels)
        self.skip = nn.Linear(in_channels, out_channels) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_conv(self.in_norm(x, silu=True))
        emb_out = self.emb_proj(F.silu(emb))
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_norm(h, scale_shift=(scale, shift), silu=True)
        else:
            h = self.out_norm(h + emb_out, silu=True)
        h = self.out_conv(self.dropout(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class SingleTokenCrossAttention(nn.Module):
    """LDM CrossAttention at one query and one key token."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, context_dim: int | None = None):
        super().__init__()
        inner, context_dim = heads * dim_head, context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        return self.to_out(self.to_v(x if context is None else context))


class GEGLUFeedForward(nn.Module):
    """LDM FeedForward with GEGLU (exact GELU)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.geglu = nn.Linear(dim, 2 * dim * mult)
        self.proj_out = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.geglu(x).chunk(2, dim=-1)
        return self.proj_out(a * F.gelu(gate))


class TransformerBlock1Token(nn.Module):
    """BasicTransformerBlock at one token."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = SingleTokenCrossAttention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = SingleTokenCrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer1Token(nn.Module):
    """LDM SpatialTransformer at sequence length 1; its ``norm`` takes the
    LDM epsilon 1e-6."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int, depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        for d in range(depth):
            self.add_module(f"block{d}", TransformerBlock1Token(inner, heads, dim_head, context_dim))
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(self.norm(x))
        for d in range(self.depth):
            h = getattr(self, f"block{d}")(h, context)
        return self.proj_out(h) + x


class UNet1DModel(nn.Module):
    """Per-node layout denoiser with the box GCN; submodules carry the JAX
    package's names."""

    def __init__(
        self,
        in_channels: int = 20,
        model_channels: int = 512,
        out_channels: int = 20,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 1, 1, 1),
        num_heads: int = 8,
        use_spatial_transformer: bool = True,
        transformer_depth: int = 1,
        conditioning_key: str = "crossattn",
        concat_dim: int = 1280,
        crossattn_dim: int = 1280,
        using_clip: bool = True,
        enable_t_emb: bool = True,
        gconv_dim: int = 64,
    ):
        super().__init__()
        self.model_channels, self.enable_t_emb = model_channels, enable_t_emb
        self.num_res_blocks, self.channel_mult = num_res_blocks, tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.concat = conditioning_key in ("concat", "hybrid")
        temb = 4 * model_channels
        self.time_embed0 = nn.Linear(model_channels, temb)
        self.time_embed1 = nn.Linear(temb, temb)

        # box message passing
        g = gconv_dim
        self.box_embeddings = nn.Linear(in_channels, g)
        self.pred_embeddings = nn.Embedding(16, 2 * g)
        if enable_t_emb:
            self.box_time_emb = nn.Linear(temb, g)
        add_dim = 512 if using_clip else 0
        self.box_graph_cov = GraphTripleConvNet(
            2 * g + add_dim + g + (g if enable_t_emb else 0), 2 * g, num_layers=5, hidden_dim=4 * g,
            residual=True, pooling="avg", mlp_normalization="batch", output_dim=concat_dim,
        )

        def res(name, cin, cout):
            self.add_module(name, ResBlock1D(cin, cout, temb, dropout=dropout))

        def attn(name, ch):
            self.add_module(name, SpatialTransformer1Token(
                ch, num_heads, ch // num_heads, crossattn_dim, depth=transformer_depth))

        ch = model_channels
        self.in_conv = nn.Linear(in_channels + (concat_dim if self.concat else 0), ch)
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                res(f"in_{level}_{i}_res", ch, mult * model_channels)
                ch = mult * model_channels
                if ds in attention_resolutions:
                    attn(f"in_{level}_{i}_attn", ch)
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.add_module(f"down_{level}", nn.Linear(ch, ch))
                chans.append(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch)
        res("mid_res2", ch, ch)
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                res(f"out_{level}_{i}_res", ch + chans.pop(), model_channels * mult)
                ch = model_channels * mult
                if ds in attention_resolutions:
                    attn(f"out_{level}_{i}_attn", ch)
                if level and i == num_res_blocks:
                    self.add_module(f"up_{level}", nn.Linear(ch, ch))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = nn.Linear(ch, out_channels)

    def time_embedding(self, timesteps: torch.Tensor) -> torch.Tensor:
        """The cos-first sinusoidal embedding of ``timesteps`` (N,) through
        the time MLP."""
        half = self.model_channels // 2
        freqs = torch.exp(
            -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
        args = timesteps[:, None].float() * freqs[None]
        sinu = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(self.time_embed0.weight.dtype)
        return self.time_embed1(F.silu(self.time_embed0(sinu)))

    def box_message_passing(self, box_t, obj_embed, triples, edge_mask, t_emb, use_running_average=True):
        """The (N, concat_dim) cross-attention context from the box GCN."""
        edges = triples[:, [0, 2]]
        obj_box = [obj_embed, self.box_embeddings(box_t)]
        if self.enable_t_emb:
            obj_box.append(self.box_time_emb(t_emb))
        out, _ = self.box_graph_cov(torch.cat(obj_box, dim=1), self.pred_embeddings(triples[:, 1]), edges,
                                    edge_mask, use_running_average)
        return out

    def forward(self, box_t: torch.Tensor, cond_dict: dict, use_running_average: bool = True) -> torch.Tensor:
        timesteps, layout = cond_dict["time_condition"], cond_dict["other_condition"]
        N = box_t.shape[0]
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(N)
        emb = self.time_embedding(timesteps)
        context = self.box_message_passing(
            box_t, layout["uc_b"], layout["preds"], layout.get("edge_mask"), emb, use_running_average
        )[:, None, :]
        h = box_t[:, None, :]
        if self.concat:
            h = torch.cat([h, context], dim=-1)
        emb = emb[:, None, :]

        def block(name, h):
            h = getattr(self, f"{name}_res")(h, emb)
            attn = getattr(self, f"{name}_attn", None)
            return h if attn is None else attn(h, context)

        h = self.in_conv(h)
        hs = [h]
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = block(f"in_{level}_{i}", h)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = getattr(self, f"down_{level}")(h)
                hs.append(h)
        h = self.mid_attn(self.mid_res1(h, emb), context)
        h = self.mid_res2(h, emb)
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = block(f"out_{level}_{i}", torch.cat([h, hs.pop()], dim=-1))
                if level and i == self.num_res_blocks:
                    h = getattr(self, f"up_{level}")(h)
        h = self.out_norm(h, silu=True)
        return self.out_conv(h)[:, 0, :]
