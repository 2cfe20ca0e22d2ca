"""EfficientUNet range-image denoiser and its MeanFlow variant, NHWC.

Port of the JAX package's ``models/efficient_unet.py``: ``TimeEmbedding``,
``UNetBlock``, ``EfficientUNet`` (``nuscenes-unet-uncond``, ``kitti-360``),
``EfficientUNetCond`` (the same network with the timestep in a condition
dict) and ``MFEfficientUNet`` (``meanflow-nusc``).  Ring convs on the periodic azimuth
axis, AdaGN timestep conditioning, FIR resampling, and full self-attention in
the deepest down block and the first up block.  Submodules carry the JAX
package's names, so a flax parameter path maps onto a ``state_dict`` key one
to one (``weights.py``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import azimuth
from ..utils.lidar import get_linear_ray_angles_np
from . import encoding as enc
from .ops import (
    MFSelfAttention2d,
    Resample,
    ResidualBlock,
    RingConv,
    SelfAttention2d,
    adm_timestep_embedding,
    sinusoidal_embedding,
)


class TimeEmbedding(nn.Module):
    """sinusoidal → Linear → SiLU → Linear; ``adm=True`` takes the ADM
    sinusoid (:func:`ops.adm_timestep_embedding`), as the v0 ``LayoutUnet``
    does.  The parameter names are the same either way."""

    def __init__(self, base_channels: int, temb_channels: int, adm: bool = False):
        super().__init__()
        self.base_channels = base_channels
        self.embed = adm_timestep_embedding if adm else sinusoidal_embedding
        self.dense_0 = nn.Linear(base_channels, temb_channels)
        self.dense_1 = nn.Linear(temb_channels, temb_channels)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        # the sinusoid is float32, and as flax promotes it against bfloat16
        # parameters, both dense layers run in float32 at any serving dtype
        h = self.embed(timesteps, self.base_channels)
        h = F.linear(h, self.dense_0.weight.float(), self.dense_0.bias.float())
        return F.linear(F.silu(h), self.dense_1.weight.float(), self.dense_1.bias.float())


def _n_tuple(x, n: int) -> tuple:
    if isinstance(x, Iterable):
        x = tuple(x)
        if len(x) != n:
            raise ValueError(f"expected {n} values, got {x}")
        return x
    return (x,) * n


def coords_of(coords: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The coordinate encoding (H, W, n) for the images ``h``: broadcast over
    the batch in ``h``'s dtype, cut to this rank's columns under the azimuth
    axis."""
    mesh = azimuth()
    if mesh is not None:
        coords = coords[:, mesh.columns(coords.shape[1])]
    return coords.to(h.dtype)[None].expand(h.shape[0], -1, -1, -1)


class UNetBlock(nn.Module):
    """[RingConv → FIR down] → residual blocks → [attention] → [FIR up →
    RingConv]."""

    def __init__(
        self,
        in_features: int,
        features: int,
        num_residual_blocks: int,
        temb_channels: int,
        gn_num_groups: int = 8,
        gn_eps: float = 1e-6,
        attn: bool = False,
        attn_num_heads: int = 8,
        up: int = 1,
        down: int = 1,
        ring: bool = False,
        mf_attn: bool = False,
    ):
        super().__init__()
        self.num_residual_blocks = num_residual_blocks
        ch = in_features
        if down > 1:
            self.down_conv = RingConv(ch, features, ring=ring)
            self.down_resample = Resample(down=down, ring=ring)
            ch = features
        for i in range(num_residual_blocks):
            self.add_module(f"res{i}", ResidualBlock(
                ch, features, temb_channels, gn_num_groups, gn_eps, ring=ring,
            ))
            ch = features
        attn_cls = MFSelfAttention2d if mf_attn else SelfAttention2d
        self.attn = attn_cls(features, attn_num_heads, gn_num_groups, gn_eps) if attn else None
        if up > 1:
            self.up_resample = Resample(up=up, ring=ring)
            self.up_conv = RingConv(features, features, ring=ring)
        self.up, self.down = up, down

    def forward(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        if self.down > 1:
            h = self.down_resample(self.down_conv(h))
        for i in range(self.num_residual_blocks):
            h = self.get_submodule(f"res{i}")(h, temb)
        if self.attn is not None:
            h = self.attn(h)
        if self.up > 1:
            h = self.up_conv(self.up_resample(h))
        return h


class EfficientUNet(nn.Module):
    """``forward(images (B,H,W,C), timesteps (B,))`` → (B,H,W,out).

    ``in_channels`` counts the image channels; the coordinate-encoding
    channels (the encoding of the ray angles for spherical projections,
    else of polar coordinates; computed on the host in float64) are added
    here.  ``mf_attn`` swaps in the MeanFlow qk-norm attention blocks.
    """

    mf_attn = False

    def __init__(
        self,
        in_channels: int,
        resolution: tuple[int, int],
        out_channels: int | None = None,
        base_channels: int = 128,
        temb_channels: int | None = None,
        channel_multiplier: Sequence[int] | int = (1, 2, 4, 8),
        num_residual_blocks: Sequence[int] | int = (3, 3, 3, 3),
        gn_num_groups: int = 8,
        gn_eps: float = 1e-6,
        attn_num_heads: int = 8,
        coords_encoding: str | None = "spherical_harmonics",
        ring: bool = True,
        use_ray_angle_coords: bool = False,
        fov_up: float = 10.0,
        fov_down: float = -30.0,
        mf_attn: bool | None = None,
    ):
        super().__init__()
        if mf_attn is not None:  # else the class's own attention blocks
            self.mf_attn = mf_attn
        self.resolution = tuple(resolution)
        if use_ray_angle_coords:
            coords = get_linear_ray_angles_np(*self.resolution, fov_up=fov_up, fov_down=fov_down)
        else:
            coords = enc.generate_polar_coords(*self.resolution).astype(np.float64)
        cenc = enc.encode_coords(coords, coords_encoding, self.resolution)
        self.register_buffer(
            "coords", None if cenc is None else torch.as_tensor(cenc), persistent=False
        )
        n_coords = 0 if cenc is None else cenc.shape[-1]

        temb = temb_channels or base_channels * 4
        self._time_embeddings(base_channels, temb)
        mult = _n_tuple(channel_multiplier, 4)
        N = _n_tuple(num_residual_blocks, 4)
        C = [base_channels] + [base_channels * m for m in mult]
        kw = dict(temb_channels=temb, gn_num_groups=gn_num_groups, gn_eps=gn_eps,
                  attn_num_heads=attn_num_heads, ring=ring, mf_attn=self.mf_attn)
        self.in_conv = RingConv(in_channels + n_coords, C[0], ring=ring)
        self.d_block1 = UNetBlock(C[0], C[1], N[0], **kw)
        self.d_block2 = UNetBlock(C[1], C[2], N[1], down=2, **kw)
        self.d_block3 = UNetBlock(C[2], C[3], N[2], down=2, **kw)
        self.d_block4 = UNetBlock(C[3], C[4], N[3], down=2, attn=True, **kw)
        self.u_block4 = UNetBlock(C[4], C[3], N[3], up=2, attn=True, **kw)
        self.u_block3 = UNetBlock(2 * C[3], C[2], N[2], up=2, **kw)
        self.u_block2 = UNetBlock(2 * C[2], C[1], N[1], up=2, **kw)
        self.u_block1 = UNetBlock(2 * C[1], C[0], N[0], **kw)
        self.out_conv = RingConv(C[0], out_channels or in_channels, ring=ring)

    def _time_embeddings(self, base_channels: int, temb: int) -> None:
        self.time_embedding = TimeEmbedding(base_channels, temb)

    def forward(self, images: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        timesteps = timesteps.expand(images.shape[0]) if timesteps.ndim == 0 else timesteps
        # the sinusoid computes in f32; the conditioning follows the image dtype
        return self.unet_body(images, self.time_embedding(timesteps).to(images.dtype))

    def unet_body(self, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        if self.coords is not None:
            h = torch.cat([h, coords_of(self.coords, h)], dim=-1)
        h = self.in_conv(h)
        h1 = self.d_block1(h, temb)
        h2 = self.d_block2(h1, temb)
        h3 = self.d_block3(h2, temb)
        h4 = self.d_block4(h3, temb)
        u = self.u_block4(h4, temb)
        u = self.u_block3(torch.cat([u, h3], dim=-1), temb)
        u = self.u_block2(torch.cat([u, h2], dim=-1), temb)
        u = self.u_block1(torch.cat([u, h1], dim=-1), temb)
        return self.out_conv(u)


class EfficientUNetCond(EfficientUNet):
    """The same network as :class:`EfficientUNet`, called as
    ``forward(images, {'time_condition': (B,), ...})``: a conditional engine
    concatenates any condition channels onto ``images`` first."""

    def forward(self, images: torch.Tensor, condition_dict: dict) -> torch.Tensor:
        return super().forward(images, condition_dict["time_condition"])


class MFEfficientUNet(EfficientUNet):
    """Two-time (t, r) UNet for MeanFlow: the same trunk with the start- and
    end-time embeddings summed and qk-norm attention blocks."""

    mf_attn = True

    def _time_embeddings(self, base_channels: int, temb: int) -> None:
        self.start_time_embedding = TimeEmbedding(base_channels, temb)
        self.end_time_embedding = TimeEmbedding(base_channels, temb)

    def forward(
        self, images: torch.Tensor, start_timesteps: torch.Tensor, end_timesteps: torch.Tensor
    ) -> torch.Tensor:
        B = images.shape[0]
        t = start_timesteps.expand(B) if start_timesteps.ndim == 0 else start_timesteps
        r = end_timesteps.expand(B) if end_timesteps.ndim == 0 else end_timesteps
        temb = self.start_time_embedding(t) + self.end_time_embedding(r)
        return self.unet_body(images, temb.to(images.dtype))
