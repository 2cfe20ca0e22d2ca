"""Shared model blocks: ring padding/conv, FIR resampling, GroupNorm
(``FusedGN``, ``GroupNorm32``, ``AdaGN``), the EfficientUNet's residual block
and its two self-attention blocks.

Port of the JAX package's ``models/ops.py``.
Activations are NHWC at every public boundary, as in the JAX package, and
stay NHWC in memory: a conv sees ``x.permute(0, 3, 1, 2)``, which PyTorch
treats as a channels-last NCHW tensor, so the port itself makes no layout
copy (cuDNN may still convert to the layout of the algorithm it picks).  The
azimuth axis (W) is periodic, so horizontal padding is circular ("ring").

Under the mesh's ``sp`` axis (``parallel/mesh.py``) each rank holds some
columns of every activation.  Inside ``Mesh.active`` the ring pad, the ring
convs and the FIR resampling take their W halo from the neighbouring ranks
(:func:`ring_wrap`; zero-padded ones, ``ring=False``, take zeros past the
global ends instead of the wrap), the GroupNorms of image activations merge their
statistics over the ranks, and the self-attention keeps its queries and
attends over every rank's keys and values, gathered in the global token
order.  Shards are even at every level, so the resampling's crops and
strides fall as in one process.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import attention
from ..kernels.groupnorm import group_norm
from ..parallel.mesh import azimuth

_RSQRT2 = 1.0 / math.sqrt(2.0)  # the residual blocks' output scale


def ring_wrap(x: torch.Tensor, left: int, right: int, ring: bool = True) -> torch.Tensor:
    """NHWC ``x`` with ``left`` and ``right`` columns of W around it: of the
    periodic W when ``ring`` (its own far edges in one process), zeros
    otherwise; under the azimuth axis the neighbouring ranks' edges, and
    past the global ends the wrap or zeros."""
    mesh = azimuth()
    if mesh is not None:
        halo_left, halo_right = mesh.halo(x, left, right, wrap=ring)
        return torch.cat([halo_left, x, halo_right], dim=2)
    if not ring:
        return F.pad(x, (0, 0, left, right))
    return torch.cat([x[:, :, x.shape[2] - left:], x, x[:, :, :right]], dim=2)


def ring_pad(x: torch.Tensor, pad: int | tuple[int, int, int, int], ring: bool = True) -> torch.Tensor:
    """Pad NHWC: circular on W if ``ring`` (zeros otherwise), zeros on H.

    ``pad`` is (left, right, top, bottom) or a single int for all sides.
    """
    left, right, top, bottom = (pad,) * 4 if isinstance(pad, int) else pad
    return F.pad(ring_wrap(x, left, right, ring), (0, 0, 0, 0, top, bottom))


def sinusoidal_embedding(x: torch.Tensor, channels: int, max_period: int = 10_000) -> torch.Tensor:
    """Sinusoidal timestep embedding [sin | cos]; ``x`` is (B,)."""
    half = channels // 2
    freqs = torch.exp(
        -math.log(max_period) / (half - 1)
        * torch.arange(half, dtype=torch.float32, device=x.device)
    )
    h = x[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(h), torch.cos(h)], dim=-1)


def adm_timestep_embedding(x: torch.Tensor, channels: int, max_period: int = 10_000) -> torch.Tensor:
    """The ADM/GLIDE timestep embedding [cos | sin]: unlike
    :func:`sinusoidal_embedding`, the frequency denominator is ``half`` (not
    ``half - 1``) and cos comes first; ``x`` is (B,)."""
    half = channels // 2
    freqs = torch.exp(
        -math.log(max_period) / half * torch.arange(half, dtype=torch.float32, device=x.device)
    )
    h = x[:, None].float() * freqs[None, :]
    return torch.cat([torch.cos(h), torch.sin(h)], dim=-1)


def softmax_f32_math(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax whose max/exp/sum run in f32 while the result keeps the
    logits' dtype."""
    if logits.dtype == torch.float32:
        return torch.softmax(logits, dim=dim)
    m = logits.amax(dim=dim, keepdim=True)
    p = torch.exp((logits - m).float())
    return (p / p.sum(dim=dim, keepdim=True)).to(logits.dtype)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → NCHW view (channels-last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels-last) tensor → NHWC view."""
    return x.permute(0, 2, 3, 1)


class RingConv(nn.Module):
    """kxk conv on NHWC with circular W padding when ``ring``, zeros on H."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: tuple[int, int] = (3, 3),
        padding: int = 1,
        stride: int = 1,
        ring: bool = False,
        use_bias: bool = True,
    ):
        super().__init__()
        self.padding, self.ring = padding, ring
        # the circular W pad is an explicit concat; H (and non-ring W) zero
        # padding folds into the conv
        conv_pad = (padding, 0) if ring else padding
        self.conv_0 = nn.Conv2d(
            in_channels, features, kernel_size, stride=stride, padding=conv_pad, bias=use_bias
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding
        if p and self.ring:
            x = ring_wrap(x, p, p)
        elif p and azimuth() is not None:  # the W zeros of the ends, the neighbours' columns between
            conv = self.conv_0
            x = to_nchw(ring_wrap(x, p, p, ring=False))
            return to_nhwc(F.conv2d(x, conv.weight, conv.bias, conv.stride, (p, 0)))
        return to_nhwc(self.conv_0(to_nchw(x)))


class Resample(nn.Module):
    """FIR up/down-sampling with window [1,3,3,1], circular on W if ``ring``.

    Zero-insertion upsampling is a stride-``up`` transposed depthwise conv and
    downsampling a stride-``down`` depthwise conv, both with the 4x4 outer
    product of the 1D window; the crops follow the JAX package's
    ``p0``/``p1``/``margin`` conventions exactly.
    """

    def __init__(
        self,
        up: int = 1,
        down: int = 1,
        window: Sequence[float] = (1.0, 3.0, 3.0, 1.0),
        ring: bool = True,
        normalize: bool = True,
    ):
        super().__init__()
        self.up, self.down, self.ring = up, down, ring
        k = torch.tensor(window, dtype=torch.float32)
        if normalize:
            k = k / k.sum()
        k = k * (up * up) ** 0.5  # gain per 1D application
        self.register_buffer("kernel_2d", torch.outer(k, k), persistent=False)
        self.n_taps = n = len(window)
        if up > 1:
            self.p0 = (n - up + 1) // 2 + up - 1
            self.p1 = (n - up) // 2
        else:
            self.p0 = (n - down + 1) // 2
            self.p1 = (n - down) // 2
        self.margin = max(self.p0, self.p1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        m, up = self.margin, self.up
        x = to_nchw(ring_pad(x, m, ring=self.ring))
        k = self.kernel_2d.to(x.dtype)[None, None].expand(C, 1, -1, -1)
        if up > 1:
            # the JAX package's dilated VALID conv at offset o is this
            # transposed conv with the flipped filter at o + n_taps - 1
            y = F.conv_transpose2d(x, k.flip(-1, -2), stride=up, groups=C)
            s = m * up - self.p0 + self.n_taps - 1
            return to_nhwc(y[:, :, s:s + H * up, s:s + W * up])
        s = m - self.p0
        Hp, Wp = x.shape[2], x.shape[3]
        xs = x[:, :, s:Hp - m + self.p1, s:Wp - m + self.p1]
        return to_nhwc(F.conv2d(xs, k, stride=self.down, groups=C))


class FusedGN(nn.Module):
    """GroupNorm with direct variance on channels-last input, with the ADM
    scale-shift conditioning and a trailing SiLU folded into one pass; the
    JAX package's ``FusedGN`` (8 groups, eps 1e-6), whose scale and bias are
    optional.

    Every call is one :func:`kernels.groupnorm.group_norm`, which takes the
    parameters and the conditioning as they are and folds them itself: its
    CUDA kernel for a tensor on the card, its plain version on the CPU.
    Under the azimuth axis a norm of image activations (``spatial``) merges
    its statistics over the ranks; a norm of tokens every rank holds whole
    (``spatial=False``: OACA's layout and positional strips) does not.
    """

    def __init__(
        self,
        channels: int,
        num_groups: int = 8,
        eps: float = 1e-6,
        use_scale: bool = True,
        use_bias: bool = True,
        spatial: bool = True,
    ):
        super().__init__()
        self.num_groups, self.eps, self.spatial = num_groups, eps, spatial
        self.weight = nn.Parameter(torch.ones(channels)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None

    def forward(
        self,
        x: torch.Tensor,
        scale_shift: tuple[torch.Tensor, torch.Tensor] | None = None,
        silu: bool = False,
    ) -> torch.Tensor:
        """``scale_shift=(s, t)`` (each with B·C values, unit channel
        stride) gives ``GN(x)·(1+s) + t``."""
        s, t = (None, None) if scale_shift is None else scale_shift
        mesh = azimuth() if self.spatial else None
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps,
                          scale=s, shift=t, silu=silu, exchange=None if mesh is None else mesh.gather_sp)


class GroupNorm32(FusedGN):
    """The layout UNet's GroupNorm: 32 groups, eps 1e-5, scale and bias."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5, spatial: bool = True):
        super().__init__(channels, num_groups, eps, spatial=spatial)


class AdaGN(nn.Module):
    """Adaptive GroupNorm: GN(x)·(1 + scale(emb)) + shift(emb), with the
    scale and shift from one ``Dense(2C)`` of ``silu(emb)`` and no affine of
    the norm's own."""

    def __init__(self, channels: int, emb_channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.dense_0 = nn.Linear(emb_channels, 2 * channels)
        self.groupnorm_0 = FusedGN(channels, num_groups, eps, use_scale=False, use_bias=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, silu: bool = False) -> torch.Tensor:
        scale, shift = self.dense_0(F.silu(emb)).chunk(2, dim=-1)
        return self.groupnorm_0(x, scale_shift=(scale, shift), silu=silu)


class ResidualBlock(nn.Module):
    """GN→SiLU→conv, AdaGN(emb)→SiLU→conv, skip, × 1/√2 (EfficientUNet)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        emb_channels: int,
        gn_num_groups: int = 8,
        gn_eps: float = 1e-6,
        ring: bool = False,
    ):
        super().__init__()
        self.groupnorm_0 = FusedGN(in_features, gn_num_groups, gn_eps)
        self.conv1 = RingConv(in_features, features, ring=ring)
        self.norm2 = AdaGN(features, emb_channels, gn_num_groups, gn_eps)
        self.conv2 = RingConv(features, features, ring=ring)
        self.skip = (
            RingConv(in_features, features, kernel_size=(1, 1), padding=0)
            if in_features != features else None
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.groupnorm_0(x, silu=True))
        h = self.conv2(self.norm2(h, emb, silu=True))
        if self.skip is not None:
            x = self.skip(x)
        return (x + h) * _RSQRT2


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, heads·d) → (B, heads, L, d), channel-blocked per head; a view."""
    B, L, C = t.shape
    return t.reshape(B, L, num_heads, C // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, heads, L, d) → (B, L, heads·d); free for the kernel's output."""
    B, H, L, d = t.shape
    return t.transpose(1, 2).reshape(B, L, H * d)


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` parameters: ``query``,
    ``key`` and ``value`` project C → heads·dh, ``out`` heads·dh → C."""

    def __init__(self, channels: int):
        super().__init__()
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)


class SelfAttention2d(nn.Module):
    """Full self-attention over H·W tokens: GroupNorm → multi-head attention
    → residual → × 1/√2.

    The three input projections run as one (B, L, 3C) matmul; the attention
    kernel reads per-head views of it and applies 1/√dh to the f32 logits.
    """

    def __init__(self, channels: int, num_heads: int = 8, gn_num_groups: int = 8, gn_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.groupnorm_0 = FusedGN(channels, gn_num_groups, gn_eps)
        self.multiheaddotproductattention_0 = MultiHeadDotProductAttention(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        mha = self.multiheaddotproductattention_0
        h = self.groupnorm_0(x).reshape(B, H * W, C)
        qkv = F.linear(
            h,
            torch.cat([mha.query.weight, mha.key.weight, mha.value.weight]),
            torch.cat([mha.query.bias, mha.key.bias, mha.value.bias]),
        )
        q, k, v = (split_heads(t, self.num_heads) for t in qkv.split(C, dim=-1))
        mesh = azimuth()
        if mesh is not None:  # this rank's queries over every rank's keys and values
            kv = mesh.gather_w(qkv[..., C:].reshape(B, H, W, 2 * C)).reshape(B, -1, 2 * C)
            k, v = (split_heads(t, self.num_heads) for t in kv.split(C, dim=-1))
        out = attention(q, k, v, scale=1.0 / math.sqrt(C // self.num_heads))
        out = mha.out(merge_heads(out)).reshape(B, H, W, C)
        return (x + out) * _RSQRT2


class MFSelfAttention2d(nn.Module):
    """MeanFlow attention block: GroupNorm → timm ``Attention`` with a
    fused qkv projection and a scalar-gain RMS qk-norm → residual → × 1/√2.

    ``qkv`` splits as (3, heads, dh); the qk-norm is
    ``t / max(‖t‖, 1e-12) · √dh · g`` over the head dim, and q alone then
    takes dh^-½, so the kernel runs with scale 1.  Under the azimuth axis the
    norm is per token, so each rank normalises its own tokens, keeps its
    queries and gathers every rank's normed keys and values, as
    :class:`SelfAttention2d` does.
    """

    def __init__(self, channels: int, num_heads: int = 8, gn_num_groups: int = 8, gn_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.groupnorm_0 = FusedGN(channels, gn_num_groups, gn_eps)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.q_norm_g = nn.Parameter(torch.ones(1))
        self.k_norm_g = nn.Parameter(torch.ones(1))
        self.proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nh = self.num_heads
        dh = C // nh
        h = self.groupnorm_0(x).reshape(B, H * W, C)
        qkv = self.qkv(h).view(B, H * W, 3, nh, dh)
        q, k, v = qkv.unbind(dim=2)  # (B, L, heads, dh) views

        def rms(t, g):
            n = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
            return n * dh**0.5 * g

        q = rms(q, self.q_norm_g) * dh**-0.5
        k = rms(k, self.k_norm_g)
        mesh = azimuth()
        if mesh is not None:  # this rank's queries over every rank's keys and values
            kv = torch.cat([k.reshape(B, H, W, C), v.reshape(B, H, W, C)], dim=-1)
            k, v = mesh.gather_w(kv).reshape(B, -1, 2, nh, dh).unbind(dim=2)
        out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=1.0)
        out = self.proj(merge_heads(out)).reshape(B, H, W, C)
        return (x + out) * _RSQRT2
