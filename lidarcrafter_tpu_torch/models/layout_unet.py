"""Layout-conditioned range-image denoisers (``LayoutUnetV1`` and the v0
``LayoutUnet``), NHWC.

Port of the JAX package's ``models/layout_unet.py``: ADM ResBlocks with
scale-shift GroupNorm conditioning, ``ObjectAwareCrossAttention`` (or
GLIDE's attention block) at the configured downsampling factors, and either
V1's FIR-resampled up/down blocks with ring convs on the periodic azimuth
axis or v0's zero-padded convs with ADM nearest / average-pool
resampling.  Submodules carry the JAX package's names, so a flax parameter
path maps onto a ``state_dict`` key one to one (``weights.py``).  Tokens
flatten row-major (h·W + w).

Both stacks run under the mesh's ``sp`` axis (``parallel/mesh.py``): the
ring and zero-padded convs, FIR resampling and GroupNorms as ``ops.py``
says, the coordinate encoding and the queries' positional rows cut to this
rank's columns, and OACA attending from this rank's queries over every
rank's image keys (gathered in the global token order, with the whole
positional strip) and the layout strip every rank holds; GLIDE's block
attends from this rank's queries over every rank's image keys and values,
gathered in the global token order, behind the encoder's tokens.  Average
pooling, nearest up-sampling and the stride-2 convs are local on even
shards (each starts on an even global column).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import attention
from ..kernels.oaca import oaca_attention
from ..parallel.mesh import azimuth
from ..utils.lidar import get_linear_ray_angles_np
from . import encoding as enc
from .efficient_unet import TimeEmbedding, coords_of
from .ops import GroupNorm32, Resample, RingConv, merge_heads, split_heads, to_nchw, to_nhwc


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest up-sampling of NHWC (each pixel repeated 2x2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling, stride 2, of NHWC."""
    return to_nhwc(F.avg_pool2d(to_nchw(x), 2, stride=2))


class ResBlockADM(nn.Module):
    """ADM residual block with optional up/down resampling: V1's FIR
    ``Resample`` (``fir``) or v0's ``h_upd``/``x_upd`` (2x nearest up,
    2x2 average-pool down); ring convs when ``ring``, zero-padded otherwise."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        emb_channels: int,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = False,
        up: bool = False,
        down: bool = False,
        ring: bool = True,
        fir: bool = True,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(in_channels)
        self.updown = None
        if (up or down) and fir:
            self.updown = Resample(up=2 if up else 1, down=2 if down else 1, ring=ring)
        elif up or down:
            self.updown = upsample_nearest2x if up else avg_pool2x
        self.in_conv = RingConv(in_channels, out_channels, ring=ring)
        emb_out = 2 * out_channels if use_scale_shift_norm else out_channels
        self.emb_proj = nn.Linear(emb_channels, emb_out)
        self.out_norm = GroupNorm32(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = RingConv(out_channels, out_channels, ring=ring)
        self.skip = (
            RingConv(in_channels, out_channels, kernel_size=(1, 1), padding=0)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_norm(x, silu=True)
        if self.updown is not None:
            h = self.updown(h)
            x = self.updown(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_norm(h, scale_shift=(scale, shift), silu=True)
        else:
            h = self.out_norm(h + emb_out[:, None, None, :], silu=True)
        h = self.out_conv(self.dropout(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 conv (``use_conv``) or 2x2 average pool; the down step of a
    stack built with ``resblock_updown=False``."""

    def __init__(self, channels: int, use_conv: bool = True, ring: bool = True):
        super().__init__()
        self.op = RingConv(channels, channels, stride=2, ring=ring) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool2x(x) if self.op is None else self.op(x)


class Upsample(nn.Module):
    """2x nearest up-sampling, then a conv (``use_conv``); the up step of a
    stack built with ``resblock_updown=False``."""

    def __init__(self, channels: int, use_conv: bool = True, ring: bool = True):
        super().__init__()
        self.conv = RingConv(channels, channels, ring=ring) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest2x(x)
        return x if self.conv is None else self.conv(x)


class GLIDEAttentionBlock(nn.Module):
    """GLIDE self-attention over the H·W tokens, with the encoder's tokens
    prepended to the keys and values when ``encoder_channels`` (the width of
    ``xf_out``) is given and the block is called with a condition dict.

    One fused ``qkv`` projection packed per head as [q|k|v] (the legacy
    packing, unlike OACA's full-width split); the kernel reads per-head
    views of it.  The reference scales q and k by 1/√√dh each, which is
    1/√dh on the float32 logits here.  ``proj_out`` closes the residual.
    """

    def __init__(self, channels: int, num_heads: int, encoder_channels: int | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.encoder_kv = None if encoder_channels is None else nn.Linear(encoder_channels, 2 * channels)
        self.proj_out = nn.Linear(channels, channels)
        self.scale = 1.0 / math.sqrt(channels // num_heads)

    def forward(self, x: torch.Tensor, cond: dict | None = None) -> torch.Tensor:
        B, H, W, C = x.shape
        nh = self.num_heads
        dh = C // nh
        tokens = x.reshape(B, H * W, C)
        qkv = self.qkv(self.norm(x)).view(B, H, W, nh, 3 * dh)
        q, k, v = (t.reshape(B, H * W, nh, dh).transpose(1, 2) for t in qkv.split(dh, dim=-1))
        mesh = azimuth()
        if mesh is not None:  # this rank's queries over every rank's keys and values, in the global order
            kv = mesh.gather_w(qkv[..., dh:]).reshape(B, -1, nh, 2 * dh)
            k, v = (t.transpose(1, 2) for t in kv.split(dh, dim=-1))
        if cond is not None and self.encoder_kv is not None:
            ekv = self.encoder_kv(cond["xf_out"])
            ek, ev = (t.transpose(1, 2) for t in ekv.view(B, -1, nh, 2 * dh).split(dh, dim=-1))
            k = torch.cat([ek, k], dim=2)
            v = torch.cat([ev, v], dim=2)
        out = self.proj_out(merge_heads(attention(q, k, v, scale=self.scale)))
        return (tokens + out).reshape(B, H, W, C)


class ObjectAwareCrossAttention(nn.Module):
    """Image-patch + layout joint attention.

    Queries are image content ⊕ patch positional embedding; keys are the same
    for image tokens and layout content ⊕ layout positional embedding for
    layout tokens; values carry content only.  Unlike a per-head packed qkv,
    the fused projection splits at full-channel width first, then per head.
    The positional embeddings are ``int(C · channels_scale_for_positional_embedding)``
    wide (projected, then normalised; normalised, then projected with
    ``norm_first``), so q and k are (1 + s)·C/heads wide and each takes the
    scale 1/√√(int((1 + s)·C) // heads).  ``norm_for_obj_embedding``
    normalises the encoder's ``xf_out`` before it enters the layout content.
    """

    def __init__(
        self,
        channels: int,
        num_heads: int,
        layout_channels: int,
        resolution: int,
        channels_scale_for_positional_embedding: float = 1.0,
        norm_first: bool = False,
        norm_for_obj_embedding: bool = False,
    ):
        super().__init__()
        C = channels
        s = channels_scale_for_positional_embedding
        pe = int(C * s)
        self.num_heads, self.resolution, self.norm_first = num_heads, resolution, norm_first
        self.norm_for_qkv = GroupNorm32(C)
        self.qkv_projector = nn.Linear(C, 3 * C)
        self.layout_position_embedding_projector = nn.Linear(layout_channels, pe)
        pe_norm = layout_channels if norm_first else pe
        # the positional and layout strips are whole on every rank: their
        # norms take no statistics from the other ranks
        self.norm_for_image_patch_positional_embedding = GroupNorm32(pe_norm, spatial=False)
        self.norm_for_layout_positional_embedding = GroupNorm32(pe_norm, spatial=False)
        self.norm_for_obj_class_embedding = GroupNorm32(layout_channels, spatial=False)
        self.norm_for_obj_embedding_gn = (
            GroupNorm32(layout_channels, spatial=False) if norm_for_obj_embedding else None)
        self.layout_content_embedding_projector = nn.Linear(layout_channels, 2 * C)
        self.proj_out = nn.Linear(C, C)
        self.scale = float(1.0 / np.sqrt(np.sqrt(int((1 + s) * C) // num_heads)))

    def _position(self, norm: nn.Module, raw: torch.Tensor) -> torch.Tensor:
        proj = self.layout_position_embedding_projector
        return proj(norm(raw)) if self.norm_first else norm(proj(raw))

    def forward(self, x: torch.Tensor, cond: dict) -> torch.Tensor:
        B, H, W, C = x.shape
        nh = self.num_heads
        tokens = x.reshape(B, H * W, C)
        # the norm of the (h, w) map, whatever its columns: the tokens' statistics
        qkv = self.qkv_projector(self.norm_for_qkv(x).reshape(B, H * W, C))
        q_c, k_c, v_c = (split_heads(t, nh) for t in qkv.chunk(3, dim=-1))

        ipe = self._position(self.norm_for_image_patch_positional_embedding,
                             cond[f"image_patch_bbox_embedding_for_resolution{self.resolution}"])
        lpe = self._position(self.norm_for_layout_positional_embedding, cond["obj_bbox_embedding"])
        cls_n = self.norm_for_obj_class_embedding(cond["obj_class_embedding"])
        xf = cond["xf_out"]
        if self.norm_for_obj_embedding_gn is not None:
            xf = self.norm_for_obj_embedding_gn(xf)
        layout_content = (xf + cls_n) / 2
        k_lc, v_lc = self.layout_content_embedding_projector(layout_content).chunk(2, dim=-1)
        k_l = torch.cat([split_heads(k_lc, nh), split_heads(lpe, nh)], dim=-1)

        mesh = azimuth()
        if mesh is None:
            out = oaca_attention(q_c, split_heads(ipe, nh), k_c, k_l, v_c, split_heads(v_lc, nh), scale=self.scale)
        else:  # this rank's queries and their positional rows; every rank's image keys, in the global order
            kv = mesh.gather_w(qkv[..., C:].reshape(B, H, W, 2 * C)).reshape(B, -1, 2 * C)
            k_c, v_c = (split_heads(t, nh) for t in kv.chunk(2, dim=-1))
            ipe_q = ipe.reshape(B, H, W * mesh.sp, -1)[:, :, mesh.columns(W * mesh.sp)].reshape(B, H * W, -1)
            out = oaca_attention(q_c, split_heads(ipe_q, nh), k_c, k_l, v_c, split_heads(v_lc, nh),
                                 scale=self.scale, ipe_k=split_heads(ipe, nh))
        out = self.proj_out(merge_heads(out))
        return (tokens + out).reshape(B, H, W, C)


class LayoutUnetV1(nn.Module):
    """Layout UNet; ``forward(x, cond_dict)`` with NHWC ``x`` and
    ``cond_dict = {'time_condition': (B,), 'other_condition': encoder outputs}``.

    ``in_channels`` counts the noisy image and the ``concat_cond`` channels;
    the coordinate-encoding channels are added here.  ``layout_channels`` is
    the condition encoder's hidden width: unlike flax, PyTorch needs it to
    size the attention blocks' layout projections.  ``attention_block_type``
    picks :class:`ObjectAwareCrossAttention` or, for any other value,
    :class:`GLIDEAttentionBlock`, which prepends the encoder's tokens to its
    keys and values unless ``encoder_channels`` is None.  The OACA options
    ``channels_scale_for_positional_embedding``, ``norm_first`` and
    ``norm_for_obj_embedding`` are its own.
    ``use_positional_embedding_for_attention`` and ``use_key_padding_mask``
    are config keys that the JAX package does not read either.

    The v0 switches: ``ring`` (circular azimuth padding), ``fir_updown``
    (FIR or nearest / average-pool resampling in the up/down ResBlocks),
    ``adm_time_embed`` (the ADM sinusoid), ``use_concat_cond`` (concatenate
    the encoder's ``concat_cond`` onto the input); ``resblock_updown=False``
    resamples with :class:`Downsample` / :class:`Upsample` instead of
    ResBlocks (``conv_resample`` gives them their conv).
    """

    def __init__(
        self,
        in_channels: int,
        resolution: tuple[int, int],
        layout_channels: int,
        model_channels: int = 64,
        out_channels: int = 2,
        num_res_blocks: int = 2,
        attention_ds: Sequence[int] = (4, 8),
        encoder_channels: int | None = 64,
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        num_heads: int = -1,
        num_head_channels: int = 32,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = True,
        image_size: int = 32,
        num_attention_blocks: int = 1,
        coords_encoding: str | None = "fourier_features",
        use_ray_angle_coords: bool = False,
        fov_up: float = 10.0,
        fov_down: float = -30.0,
        attention_block_type: str = "ObjectAwareCrossAttention",
        resblock_updown: bool = True,
        conv_resample: bool = True,
        use_positional_embedding_for_attention: bool = True,
        ring: bool = True,
        fir_updown: bool = True,
        adm_time_embed: bool = False,
        use_concat_cond: bool = True,
        use_key_padding_mask: bool = False,
        channels_scale_for_positional_embedding: float = 1.0,
        norm_first: bool = False,
        norm_for_obj_embedding: bool = False,
    ):
        super().__init__()
        self.use_concat_cond = use_concat_cond
        self.resolution = tuple(resolution)
        self.model_channels, self.channel_mult = model_channels, tuple(channel_mult)
        self.num_res_blocks, self.attention_ds = num_res_blocks, tuple(attention_ds)
        self.num_attention_blocks = num_attention_blocks
        self.num_heads, self.num_head_channels = num_heads, num_head_channels
        self.num_heads_upsample = num_heads_upsample

        if coords_encoding is not None:
            if use_ray_angle_coords:
                coords = get_linear_ray_angles_np(*self.resolution, fov_up=fov_up, fov_down=fov_down)
            else:
                coords = enc.generate_polar_coords(*self.resolution).astype(np.float64)
            cenc = enc.encode_coords(coords, coords_encoding, self.resolution)
            self.register_buffer("coords", torch.as_tensor(cenc), persistent=False)
        else:
            self.coords = None
        n_coords = 0 if self.coords is None else self.coords.shape[-1]

        temb = model_channels * 4
        self.time_embed = TimeEmbedding(model_channels, temb, adm=adm_time_embed)

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlockADM(
                cin, cout, temb, dropout=dropout, use_scale_shift_norm=use_scale_shift_norm,
                ring=ring, fir=fir_updown, **kw,
            ))

        def attn(name, ch, ds, upsample):
            if attention_block_type == "ObjectAwareCrossAttention":
                block = ObjectAwareCrossAttention(
                    ch, self._heads(ch, upsample), layout_channels, resolution=int(image_size // ds),
                    channels_scale_for_positional_embedding=channels_scale_for_positional_embedding,
                    norm_first=norm_first, norm_for_obj_embedding=norm_for_obj_embedding,
                )
            else:  # any other type is GLIDE's block, as in the JAX package
                block = GLIDEAttentionBlock(
                    ch, self._heads(ch, upsample), None if encoder_channels is None else layout_channels,
                )
            self.add_module(name, block)

        ch = int(channel_mult[0] * model_channels)
        self.in_conv = RingConv(in_channels + n_coords, ch, ring=ring)
        skips = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                out = int(mult * model_channels)
                res(f"in_{level}_{i}_res", ch, out)
                ch = out
                if ds in self.attention_ds:
                    for a in range(num_attention_blocks):
                        attn(f"in_{level}_{i}_attn{a}", ch, ds, False)
                skips.append(ch)
            if level != len(channel_mult) - 1:
                if resblock_updown:
                    res(f"down_{level}", ch, ch, down=True)
                else:
                    self.add_module(f"down_{level}", Downsample(ch, conv_resample, ring=ring))
                skips.append(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch, ds, False)
        res("mid_res2", ch, ch)
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                out = int(model_channels * mult)
                res(f"out_{level}_{i}_res", ch + skips.pop(), out)
                ch = out
                if ds in self.attention_ds:
                    for a in range(num_attention_blocks):
                        attn(f"out_{level}_{i}_attn{a}", ch, ds, True)
                if level and i == num_res_blocks:
                    if resblock_updown:
                        res(f"up_{level}", ch, ch, up=True)
                    else:
                        self.add_module(f"up_{level}", Upsample(ch, conv_resample, ring=ring))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = RingConv(ch, out_channels, ring=ring)

    def _heads(self, ch: int, upsample: bool = False) -> int:
        if self.num_head_channels == -1:
            n = self.num_heads_upsample if (upsample and self.num_heads_upsample != -1) else self.num_heads
            return max(n, 1)
        return ch // self.num_head_channels

    def _attend(self, prefix: str, h: torch.Tensor, ds: int, layout: dict) -> torch.Tensor:
        if ds in self.attention_ds:
            for a in range(self.num_attention_blocks):
                h = self.get_submodule(f"{prefix}_attn{a}")(h, layout)
        return h

    def _resample(self, name: str, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        block = self.get_submodule(name)
        return block(h, emb) if isinstance(block, ResBlockADM) else block(h)

    def forward(self, x: torch.Tensor, cond_dict: dict) -> torch.Tensor:
        timesteps = cond_dict["time_condition"]
        layout = cond_dict["other_condition"]
        B = x.shape[0]
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        emb = self.time_embed(timesteps)
        emb = (emb + layout["xf_proj"].to(emb.dtype)).to(x.dtype)

        h = x
        if self.use_concat_cond and "concat_cond" in layout:
            h = torch.cat([h, layout["concat_cond"].to(h.dtype)], dim=-1)
        if self.coords is not None:
            h = torch.cat([h, coords_of(self.coords, h)], dim=-1)

        h = self.in_conv(h)
        hs = [h]
        ds = 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = self.get_submodule(f"in_{level}_{i}_res")(h, emb)
                h = self._attend(f"in_{level}_{i}", h, ds, layout)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = self._resample(f"down_{level}", h, emb)
                hs.append(h)
                ds *= 2

        h = self.mid_res1(h, emb)
        h = self.mid_attn(h, layout)
        h = self.mid_res2(h, emb)

        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                h = self.get_submodule(f"out_{level}_{i}_res")(h, emb)
                h = self._attend(f"out_{level}_{i}", h, ds, layout)
                if level and i == self.num_res_blocks:
                    h = self._resample(f"up_{level}", h, emb)
                    ds //= 2

        h = self.out_norm(h, silu=True)
        return self.out_conv(h)


class LayoutUnet(LayoutUnetV1):
    """The v0 stack (registry key ``layout_unet``, ``nuscenes-box-layout``):
    :class:`LayoutUnetV1` with zero-padded convs, ADM nearest / average-pool
    resampling in the up/down ResBlocks, the ADM timestep sinusoid, and no
    coordinate encoding or ``concat_cond`` input (the layout enters through
    cross-attention and ``xf_proj`` alone)."""

    def __init__(
        self,
        in_channels: int,
        layout_channels: int,
        resolution: tuple[int, int] = (32, 1024),
        ring: bool = False,
        fir_updown: bool = False,
        adm_time_embed: bool = True,
        use_concat_cond: bool = False,
        coords_encoding: str | None = None,
        **kwargs,
    ):
        super().__init__(
            in_channels, resolution, layout_channels, ring=ring, fir_updown=fir_updown,
            adm_time_embed=adm_time_embed, use_concat_cond=use_concat_cond,
            coords_encoding=coords_encoding, **kwargs,
        )
