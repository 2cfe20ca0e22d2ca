"""The OpenAI / LDM ADM UNet (registry key ``openai_unet``), NHWC.

Port of the JAX package's ``models/openai_unet.py``: the ADM trunk of the
layout UNet (``ResBlockADM`` with ring convs, ``Downsample`` / ``Upsample``
or up/down ResBlocks) with

- the LDM timestep embedding (:func:`ldm_timestep_embedding`: cos first,
  frequencies over ``half``) ahead of two Linears, cast to the image's
  dtype first;
- optional class conditioning (``label_emb``) and coordinate encodings of
  the polar grid;
- at the attention resolutions either GLIDE's attention block (no encoder
  tokens) through the attention kernel, or a ``SpatialTransformer``:
  GroupNorm (eps 1e-6, through the GroupNorm kernel) → Linear in →
  ``depth`` pre-LayerNorm blocks of self-attention, cross-attention over
  the context and a GEGLU feed-forward → zero-initialised Linear out, plus
  the skip.  The transformer's attention stays plain PyTorch einsums, as
  the JAX package computes it in XLA.

Submodules carry the JAX package's names, so a flax parameter path maps
onto a ``state_dict`` key one to one (``weights.py``).  The constructor
takes the JAX model's fields and nothing else; like the JAX package, no
config of the registry builds it and no factory route reaches it.

Under the mesh's ``sp`` axis (``parallel/mesh.py``) the trunk runs as the
layout UNet's does (``layout_unet.py``), the coordinate encodings cut to
this rank's columns; the transformers' self-attention attends from this
rank's tokens over every rank's keys and values, gathered in the global
token order, and their cross-attention over the context every rank holds.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import azimuth
from . import encoding as enc
from .efficient_unet import coords_of
from .layout_unet import Downsample, GLIDEAttentionBlock, ResBlockADM, Upsample
from .ops import GroupNorm32, RingConv

LN_EPS = 1e-6  # flax nn.LayerNorm


def ldm_timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10_000) -> torch.Tensor:
    """The LDM sinusoid [cos | sin] of (B,) ``t``, frequencies
    exp(−log(max_period)·i / half); zero-padded to an odd ``dim``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class GEGLU(nn.Module):
    """LDM feed-forward gate: ``a · gelu(b)`` of one Linear's two halves
    (flax's tanh-approximate GELU)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b, approximate="tanh")


class CrossAttention(nn.Module):
    """Multi-head attention of the tokens ``x`` (B, ..., dim) over
    ``context`` (B, L, context_dim; ``x`` itself when None); bias-free q /
    k / v projections, softmax of the logits over √head_dim.  Under the
    azimuth axis a self-attention's ``x`` is the rank's columns of an NHWC
    token map, whose keys and values it gathers from every rank."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int | None = None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        B, nh, hd = x.shape[0], self.num_heads, self.head_dim
        q = self.to_q(x).reshape(B, -1, nh, hd)
        ctx = x if context is None else context
        k, v = self.to_k(ctx), self.to_v(ctx)
        mesh = azimuth() if context is None else None
        if mesh is not None:  # this rank's tokens over every rank's keys and values
            if x.ndim != 4:
                raise ValueError("a self-attention under the azimuth axis takes an NHWC token map")
            k, v = mesh.gather_w(torch.cat([k, v], dim=-1)).chunk(2, dim=-1)
        k, v = k.reshape(B, -1, nh, hd), v.reshape(B, -1, nh, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(attn, dim=-1), v)
        return self.to_out(out.reshape(*x.shape[:-1], -1))


class BasicTransformerBlock(nn.Module):
    """Pre-LayerNorm self-attention, cross-attention and GEGLU feed-forward,
    each a residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int | None = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = CrossAttention(dim, num_heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = CrossAttention(dim, num_heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff_geglu = GEGLU(dim, 4 * dim)
        self.ff_out = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(self.ff_geglu(self.norm3(x)))


class SpatialTransformer(nn.Module):
    """GroupNorm (32 groups, eps 1e-6) → Linear in → ``depth`` transformer
    blocks over the H·W tokens (kept as an NHWC map, token order h·W + w)
    → zero-initialised Linear out, plus the skip."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, depth: int = 1,
                 context_dim: int | None = None):
        super().__init__()
        inner = num_heads * head_dim
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        for d in range(depth):
            self.add_module(f"block{d}", BasicTransformerBlock(inner, num_heads, head_dim, context_dim))
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        h = self.proj_in(self.norm(x))
        for d in range(self.depth):
            h = self.get_submodule(f"block{d}")(h, context)
        return x + self.proj_out(h)


class OpenAIUNet(nn.Module):
    """``forward(x (B, H, W, C), cond_dict, y=None)`` with ``cond_dict =
    {'time_condition': (B,), 'other_condition': optional (B, L, D) context
    of the SpatialTransformers}``; ``y`` (B,) class labels when
    ``num_classes`` is set (and only then).

    ``in_channels`` counts the image channels; the coordinate-encoding
    channels are added here.  With ``num_heads = num_head_channels = -1``
    (the defaults) every attention block has one head as wide as its
    channels.  ``context_dim`` is the context's width (None: the
    transformers' cross-attention attends to the tokens themselves).
    """

    def __init__(
        self,
        resolution: tuple[int, int],
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int] = (4, 8),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_classes: int | None = None,
        num_heads: int = -1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_spatial_transformer: bool = False,
        transformer_depth: int = 1,
        context_dim: int | None = None,
        ring: bool = True,
        coords_encoding: str | None = None,
    ):
        super().__init__()
        self.resolution = tuple(resolution)
        self.channel_mult, self.num_res_blocks = tuple(channel_mult), num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.num_classes = num_classes
        self.num_heads, self.num_head_channels = num_heads, num_head_channels
        self.num_heads_upsample = num_heads_upsample
        self.use_spatial_transformer = use_spatial_transformer

        if coords_encoding is not None:
            coords = enc.generate_polar_coords(*self.resolution).astype(np.float64)
            cenc = enc.encode_coords(coords, coords_encoding, self.resolution)
            self.register_buffer("coords", torch.as_tensor(cenc), persistent=False)
        else:
            self.coords = None
        n_coords = 0 if self.coords is None else self.coords.shape[-1]

        temb = model_channels * 4
        self.time_dense1 = nn.Linear(model_channels, temb)
        self.time_dense2 = nn.Linear(temb, temb)
        self.label_emb = nn.Embedding(num_classes, temb) if num_classes is not None else None

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlockADM(
                cin, cout, temb, dropout=dropout, use_scale_shift_norm=use_scale_shift_norm, ring=ring, **kw,
            ))

        def attn(name, ch, upsample):
            heads, dim_head = self._heads_dim(ch, upsample)
            if use_spatial_transformer:
                block = SpatialTransformer(ch, heads, dim_head, transformer_depth, context_dim)
            else:
                block = GLIDEAttentionBlock(ch, heads, encoder_channels=None)
            self.add_module(name, block)

        ch = model_channels
        self.in_conv = RingConv(in_channels + n_coords, ch, ring=ring)
        skips = [ch]
        ds = 1
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                out = int(mult * model_channels)
                res(f"in_{level}_{i}_res", ch, out)
                ch = out
                if ds in self.attention_resolutions:
                    attn(f"in_{level}_{i}_attn", ch, False)
                skips.append(ch)
            if level != len(self.channel_mult) - 1:
                if resblock_updown:
                    res(f"in_{level}_down", ch, ch, down=True)
                else:
                    self.add_module(f"in_{level}_down", Downsample(ch, conv_resample, ring=ring))
                skips.append(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch, False)
        res("mid_res2", ch, ch)
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            for i in range(num_res_blocks + 1):
                out = int(mult * model_channels)
                res(f"out_{level}_{i}_res", ch + skips.pop(), out)
                ch = out
                if ds in self.attention_resolutions:
                    attn(f"out_{level}_{i}_attn", ch, True)
                if level and i == num_res_blocks:
                    if resblock_updown:
                        res(f"out_{level}_up", ch, ch, up=True)
                    else:
                        self.add_module(f"out_{level}_up", Upsample(ch, conv_resample, ring=ring))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = RingConv(ch, out_channels, ring=ring)

    def _heads_dim(self, ch: int, upsample: bool = False) -> tuple[int, int]:
        """(heads, head width) of an attention block at ``ch`` channels."""
        n = self.num_heads if self.num_head_channels == -1 else ch // self.num_head_channels
        if upsample and self.num_heads_upsample != -1 and not self.use_spatial_transformer:
            n = self.num_heads_upsample
        n = max(n, 1)
        return n, ch // n

    def _attend(self, name: str, h: torch.Tensor, context) -> torch.Tensor:
        block = self.get_submodule(name)
        return block(h, context if self.use_spatial_transformer else None)

    def _resample(self, name: str, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        block = self.get_submodule(name)
        return block(h, emb) if isinstance(block, ResBlockADM) else block(h)

    def forward(self, x: torch.Tensor, cond_dict: dict, y: torch.Tensor | None = None) -> torch.Tensor:
        timesteps = cond_dict["time_condition"]
        context = cond_dict.get("other_condition")
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("OpenAIUNet: class labels y are given exactly when num_classes is set")
        B = x.shape[0]
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        emb = ldm_timestep_embedding(timesteps, self.time_dense1.in_features).to(x.dtype)
        emb = self.time_dense2(F.silu(self.time_dense1(emb)))
        if self.label_emb is not None:
            emb = emb + self.label_emb(y)

        h = x
        if self.coords is not None:
            h = torch.cat([h, coords_of(self.coords, h)], dim=-1)
        h = self.in_conv(h)
        hs = [h]
        ds = 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = self.get_submodule(f"in_{level}_{i}_res")(h, emb)
                if ds in self.attention_resolutions:
                    h = self._attend(f"in_{level}_{i}_attn", h, context)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = self._resample(f"in_{level}_down", h, emb)
                hs.append(h)
                ds *= 2

        h = self.mid_res1(h, emb)
        h = self._attend("mid_attn", h, context)
        h = self.mid_res2(h, emb)

        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = self.get_submodule(f"out_{level}_{i}_res")(torch.cat([h, hs.pop()], dim=-1), emb)
                if ds in self.attention_resolutions:
                    h = self._attend(f"out_{level}_{i}_attn", h, context)
                if level and i == self.num_res_blocks:
                    h = self._resample(f"out_{level}_up", h, emb)
                    ds //= 2
        return self.out_conv(self.out_norm(h, silu=True))
