"""Layout-conditioned range-image denoiser (``LayoutUnetV1``), NHWC.

Port of the JAX package's ``models/layout_unet.py``: ADM ResBlocks with
scale-shift GroupNorm conditioning and FIR-resampled up/down blocks, ring
convs on the periodic azimuth axis, and ``ObjectAwareCrossAttention`` at the
configured downsampling factors.  Submodules carry the JAX package's names,
so a flax parameter path maps onto a ``state_dict`` key one to one
(``weights.py``).  Tokens flatten row-major (h·W + w).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.oaca import oaca_attention
from ..utils.lidar import get_linear_ray_angles_np
from . import encoding as enc
from .efficient_unet import TimeEmbedding
from .ops import GroupNorm32, Resample, RingConv, merge_heads, split_heads


class ResBlockADM(nn.Module):
    """ADM residual block with optional FIR up/down resampling; ring convs."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        emb_channels: int,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = False,
        up: bool = False,
        down: bool = False,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(in_channels)
        self.updown = (
            Resample(up=2 if up else 1, down=2 if down else 1) if up or down else None
        )
        self.in_conv = RingConv(in_channels, out_channels, ring=True)
        emb_out = 2 * out_channels if use_scale_shift_norm else out_channels
        self.emb_proj = nn.Linear(emb_channels, emb_out)
        self.out_norm = GroupNorm32(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.out_conv = RingConv(out_channels, out_channels, ring=True)
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


class ObjectAwareCrossAttention(nn.Module):
    """Image-patch + layout joint attention.

    Queries are image content ⊕ patch positional embedding; keys are the same
    for image tokens and layout content ⊕ layout positional embedding for
    layout tokens; values carry content only.  Unlike a per-head packed qkv,
    the fused projection splits at full-channel width first, then per head.
    Positional embeddings are C wide (projected, then normalised), so q and k
    are 2C/heads wide and each takes the scale 1/√√(2C/heads).
    """

    def __init__(self, channels: int, num_heads: int, layout_channels: int, resolution: int):
        super().__init__()
        C = channels
        self.num_heads, self.resolution = num_heads, resolution
        self.norm_for_qkv = GroupNorm32(C)
        self.qkv_projector = nn.Linear(C, 3 * C)
        self.layout_position_embedding_projector = nn.Linear(layout_channels, C)
        self.norm_for_image_patch_positional_embedding = GroupNorm32(C)
        self.norm_for_layout_positional_embedding = GroupNorm32(C)
        self.norm_for_obj_class_embedding = GroupNorm32(layout_channels)
        self.layout_content_embedding_projector = nn.Linear(layout_channels, 2 * C)
        self.proj_out = nn.Linear(C, C)
        self.scale = float(1.0 / np.sqrt(np.sqrt(2 * C // num_heads)))

    def forward(self, x: torch.Tensor, cond: dict) -> torch.Tensor:
        B, H, W, C = x.shape
        nh = self.num_heads
        tokens = x.reshape(B, H * W, C)
        qkv = self.qkv_projector(self.norm_for_qkv(tokens))
        q_c, k_c, v_c = (split_heads(t, nh) for t in qkv.chunk(3, dim=-1))

        pos_proj = self.layout_position_embedding_projector
        ipe = self.norm_for_image_patch_positional_embedding(
            pos_proj(cond[f"image_patch_bbox_embedding_for_resolution{self.resolution}"])
        )
        lpe = self.norm_for_layout_positional_embedding(pos_proj(cond["obj_bbox_embedding"]))
        cls_n = self.norm_for_obj_class_embedding(cond["obj_class_embedding"])
        layout_content = (cond["xf_out"] + cls_n) / 2
        k_lc, v_lc = self.layout_content_embedding_projector(layout_content).chunk(2, dim=-1)
        k_l = torch.cat([split_heads(k_lc, nh), split_heads(lpe, nh)], dim=-1)

        out = oaca_attention(
            q_c, split_heads(ipe, nh), k_c, k_l, v_c, split_heads(v_lc, nh),
            scale=self.scale,
        )
        out = self.proj_out(merge_heads(out))
        return (tokens + out).reshape(B, H, W, C)


class LayoutUnetV1(nn.Module):
    """Layout UNet; ``forward(x, cond_dict)`` with NHWC ``x`` and
    ``cond_dict = {'time_condition': (B,), 'other_condition': encoder outputs}``.

    ``in_channels`` counts the noisy image and the ``concat_cond`` channels;
    the coordinate-encoding channels are added here.  ``layout_channels`` is
    the condition encoder's hidden width: unlike flax, PyTorch needs it to
    size the attention blocks' layout projections.  ``encoder_channels`` and
    ``use_positional_embedding_for_attention`` are config keys that the JAX
    package does not read either.
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
        use_positional_embedding_for_attention: bool = True,
    ):
        super().__init__()
        if attention_block_type != "ObjectAwareCrossAttention" or not resblock_updown:
            raise NotImplementedError(
                "the port builds LayoutUnetV1 with ObjectAwareCrossAttention and "
                "resblock_updown=True only"
            )
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
        self.time_embed = TimeEmbedding(model_channels, temb)

        def res(name, cin, cout, **kw):
            self.add_module(name, ResBlockADM(
                cin, cout, temb, dropout=dropout, use_scale_shift_norm=use_scale_shift_norm, **kw,
            ))

        def attn(name, ch, ds, upsample):
            self.add_module(name, ObjectAwareCrossAttention(
                ch, self._heads(ch, upsample), layout_channels, resolution=int(image_size // ds),
            ))

        ch = int(channel_mult[0] * model_channels)
        self.in_conv = RingConv(in_channels + n_coords, ch, ring=True)
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
                res(f"down_{level}", ch, ch, down=True)
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
                    res(f"up_{level}", ch, ch, up=True)
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = RingConv(ch, out_channels, ring=True)

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

    def forward(self, x: torch.Tensor, cond_dict: dict) -> torch.Tensor:
        timesteps = cond_dict["time_condition"]
        layout = cond_dict["other_condition"]
        B = x.shape[0]
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        emb = self.time_embed(timesteps)
        emb = (emb + layout["xf_proj"].to(emb.dtype)).to(x.dtype)

        h = x
        if "concat_cond" in layout:
            h = torch.cat([h, layout["concat_cond"].to(h.dtype)], dim=-1)
        if self.coords is not None:
            cenc = self.coords.to(h.dtype)[None].expand(B, -1, -1, -1)
            h = torch.cat([h, cenc], dim=-1)

        h = self.in_conv(h)
        hs = [h]
        ds = 1
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = self.get_submodule(f"in_{level}_{i}_res")(h, emb)
                h = self._attend(f"in_{level}_{i}", h, ds, layout)
                hs.append(h)
            if level != len(self.channel_mult) - 1:
                h = self.get_submodule(f"down_{level}")(h, emb)
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
                    h = self.get_submodule(f"up_{level}")(h, emb)
                    ds //= 2

        h = self.out_norm(h, silu=True)
        return self.out_conv(h)
