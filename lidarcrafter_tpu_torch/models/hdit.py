"""HDiT: the hourglass diffusion transformer backbone (``nuscenes-hdit-uncond``),
NHWC.

Port of the JAX package's ``models/hdit.py`` in plain PyTorch: the JAX
package computes it in XLA einsums and reaches no Pallas kernel, so no
kernel of the port runs here either.

- tokens: a (1, 4) patch conv, then a learnable ``spatial_pe``, or an
  absolute embedding: the patch-averaged polar coordinates encoded as
  spherical harmonics, polar coordinates or Fourier features, through
  ``ape_linear`` and a mapping network (``spatial_mapping``);
- time: random Fourier features (``rff_freqs``, a buffer) → ``rff_linear``
  → a mapping network of RMSNorms and GEGLU residual MLPs;
- three local levels of ``HDiTBlock``s, each a 3×9 circular-neighbourhood
  self-attention (the window clamped on H, wrapped on W) and a GEGLU
  feed-forward, both behind AdaRMSNorm; patch merging between levels, patch
  expanding with a learnable sigmoid lerp onto the skip on the way up;
- global attention at the middle level;
- every attention normalises q and k (cosine attention) and scales them by
  a learnable per-head log scale, rotates them by a harmonic-limited axial
  RoPE over the (polar, azimuth) coordinates of the tokens, and computes its
  logits, softmax and value sum in float32.

Served in bfloat16 (``to_serving_dtype_``), the weights are bf16 and every
product follows flax's promotion, as the JAX package's bf16 serving does: a
bf16 weight meeting a float32 activation computes in float32
(:func:`dense`).  The time embedding rounds ``rff_freqs`` (a float32
buffer) to the weights' dtype, as the JAX serving cast rounds that
parameter, so it computes in bf16 from the bf16 time; the normalised q and k
return to the stream's dtype before the RoPE.  The stream turns float32 at
the first attention output (its float32 logits promote the values), as in
the JAX model, so a bf16 call computes in float32 from there on.

Under the mesh's ``sp`` axis (``parallel/mesh.py``) each rank holds some
token columns of every level: the patch conv, the mapping networks, the
feed-forwards and the patch merging and expanding are local on shards that
stay even to the global level (``train.py::check_sp``); the learnable
``spatial_pe``, the absolute embedding's coordinates and the RoPE tables are
cut to the rank's columns; a neighbourhood attention takes a ring halo of
``kw // 2`` token columns of its (rotated) keys and values from the
neighbouring ranks and indexes the shard plus its halo
(:func:`halo_neighborhood_indices`; the H clamp unchanged); the global
level's attention gathers every rank's keys and values in the global token
order.

Submodules carry the JAX package's names, so a flax parameter path maps onto
a ``state_dict`` key one to one (``weights.py``): the norms' ``scale`` is
``weight``; the attention's per-head log scale keeps the name ``scale``
(a (heads, 1) leaf); ``rff_freqs``, ``spatial_pe`` and ``expand_{i}_alpha``
keep theirs.  The neighbourhood gather builds (B, H, W, 27, heads, dh)
keys and values: at full width, level 0 holds 8 × 32 × 256 tokens × 27
neighbours × 128 channels, ≈ 226 MB each in float32 at B=8.
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
from .ops import softmax_f32_math

RMS_EPS = 1e-6


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype of ``x`` and the weight, as flax's
    ``Dense`` computes mixed operands."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None = None, eps: float = RMS_EPS) -> torch.Tensor:
    """x / RMS(x) over the last axis in float32 (times ``scale``), cast
    back to ``x.dtype``."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        normed = normed * scale
    return normed.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


class AdaRMSNorm(nn.Module):
    """RMSNorm(x) × (1 + proj(emb)), ``proj`` without bias."""

    def __init__(self, dim: int, emb_dim: int):
        super().__init__()
        self.proj = nn.Linear(emb_dim, dim, bias=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return rms_norm(x) * (1 + dense(self.proj, emb)[:, None, None, :])


def rope_freqs(head_dim: int, num_heads: int, max_harmonic: int) -> np.ndarray:
    """Integer RoPE frequencies, log-spaced from 1 to ``max_harmonic`` over
    heads · head_dim/4 values, as (heads, head_dim/4)."""
    n = num_heads * head_dim // 4
    f = np.exp(np.linspace(math.log(1.0), math.log(max(max_harmonic, 1)), n))
    return np.round(f).reshape(head_dim // 4, num_heads).T


def axial_rope_theta(coords: torch.Tensor, freqs_h: torch.Tensor, freqs_w: torch.Tensor) -> torch.Tensor:
    """coords (H, W, 2) [phi, theta] → (H, W, heads, head_dim/2) radians."""
    rad_h = coords[..., 0][..., None, None] * freqs_h[None, None]
    rad_w = coords[..., 1][..., None, None] * freqs_w[None, None]
    return torch.cat([rad_h, rad_w], dim=-1)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first 2·|theta| channels of ``x`` (halves as pairs)."""
    d = cos.shape[-1] * 2
    xr, rest = x[..., :d], x[..., d:]
    x1, x2 = xr.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, rest], dim=-1)


def neighborhood_indices(H: int, W: int, kh: int, kw: int, circular_w: bool = True):
    """(H, W, kh·kw) row and column indices of each token's neighbours: the
    window is clamped inside the image on H (natten semantics) and wraps
    around on W when ``circular_w``."""
    hs = np.arange(H)
    start_h = np.clip(hs - kh // 2, 0, max(H - kh, 0))
    nh = start_h[:, None] + np.arange(kh)[None]
    ws = np.arange(W)
    if circular_w:
        nw = (ws[:, None] - kw // 2 + np.arange(kw)[None]) % W
    else:
        start_w = np.clip(ws - kw // 2, 0, max(W - kw, 0))
        nw = start_w[:, None] + np.arange(kw)[None]
    hh = np.broadcast_to(nh[:, None, :, None], (H, W, kh, kw))
    ww = np.broadcast_to(nw[None, :, None, :], (H, W, kh, kw))
    return hh.reshape(H, W, kh * kw), ww.reshape(H, W, kh * kw)


def halo_neighborhood_indices(H: int, W: int, kh: int, kw: int) -> np.ndarray:
    """(H, W, kh·kw) flat indices of each token's neighbours in an
    (H, W + 2·(kw // 2)) map: a shard of W columns with a halo of kw // 2
    columns on each side.  Rows are clamped as :func:`neighborhood_indices`
    clamps them; the window of column w is columns w … w + kw − 1 of the
    map, centred on w, whose wrap the halo carries."""
    hh, _ = neighborhood_indices(H, W, kh, kw)
    ww = np.arange(W)[:, None] + np.arange(kw)[None]
    ww = np.broadcast_to(ww[None, :, None, :], (H, W, kh, kw)).reshape(H, W, kh * kw)
    return hh * (W + 2 * (kw // 2)) + ww


class SelfAttention(nn.Module):
    """Global (``kernel_size`` None) or circular-neighbourhood cosine
    attention with axial RoPE over the tokens of one level.

    ``coords`` (H, W, 2) are the level's token coordinates; the rotation
    angles and the neighbour indices depend on them and the static sizes
    only, so they are built here once."""

    def __init__(
        self,
        dim: int,
        emb_dim: int,
        num_heads: int,
        coords: torch.Tensor,
        rope_max_harmonics: tuple[int, int] = (1, 1),
        kernel_size: tuple[int, int] | None = None,
        eps: float = 1e-6,
    ):
        super().__init__()
        self.num_heads, self.eps = num_heads, eps
        dh = dim // num_heads
        self.norm = AdaRMSNorm(dim, emb_dim)
        self.qkv_proj = nn.Linear(dim, 3 * dim, bias=False)
        self.scale = nn.Parameter(torch.full((num_heads, 1), math.log(10.0)))
        self.out_proj = nn.Linear(dim, dim, bias=False)
        fh = torch.as_tensor(rope_freqs(dh, num_heads, rope_max_harmonics[0]), dtype=torch.float32)
        fw = torch.as_tensor(rope_freqs(dh, num_heads, rope_max_harmonics[1]), dtype=torch.float32)
        theta = axial_rope_theta(coords, fh, fw)  # (H, W, heads, dh/2)
        self.register_buffer("rope_cos", torch.cos(theta), persistent=False)
        self.register_buffer("rope_sin", torch.sin(theta), persistent=False)
        self.kernel_size = kernel_size
        self._halo_cache = {}
        if kernel_size is not None:
            H, W = coords.shape[:2]
            hh, ww = neighborhood_indices(H, W, *kernel_size, circular_w=True)
            self.register_buffer("neighbors", torch.as_tensor((hh * W + ww).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nh = self.num_heads
        dh = C // nh
        qkv = dense(self.qkv_proj, self.norm(x, emb)).reshape(B, H, W, 3, nh, dh)
        q, k, v = qkv.unbind(dim=3)
        scale = torch.sqrt(torch.exp(torch.clamp(self.scale, max=math.log(100.0))))

        def normalize(t):  # cosine attention: normalised in float32, times the per-head scale
            t32 = t.float()
            t32 = t32 / torch.clamp(torch.linalg.vector_norm(t32, dim=-1, keepdim=True), min=self.eps)
            return (t32 * scale).to(t.dtype)

        cos, sin = self.rope_cos, self.rope_sin
        mesh = azimuth()
        if mesh is not None:  # this rank's columns of the level's angles
            cols = mesh.columns(cos.shape[1])
            cos, sin = cos[:, cols], sin[:, cols]
        q = rope_rotate(normalize(q), cos, sin)
        k = rope_rotate(normalize(k), cos, sin)
        neighbors = self.neighbors if self.kernel_size is not None else None
        Wk = W  # the key map's columns: under the mesh, the shard's and its halo
        if mesh is not None and self.kernel_size is None:  # every rank's keys and values, in the global order
            k, v = mesh.gather_w(torch.cat([k, v], dim=-1)).chunk(2, dim=-1)
        elif mesh is not None:  # the shard with a halo of the neighbours' columns
            pad = self.kernel_size[1] // 2
            left, right = mesh.halo(torch.cat([k, v], dim=-1), pad, pad)
            k, v = torch.cat([left, torch.cat([k, v], dim=-1), right], dim=2).chunk(2, dim=-1)
            neighbors, Wk = self._halo_neighbors(H, W, x.device), W + 2 * pad
        v = v.float()
        if self.kernel_size is None:
            qf = q.reshape(B, H * W, nh, dh).transpose(1, 2)
            kf, vf = (t.reshape(B, -1, nh, dh).transpose(1, 2) for t in (k, v))
            w = softmax_f32_math(torch.einsum("bhtd,bhsd->bhts", qf, kf))
            out = torch.einsum("bhts,bhsd->bhtd", w, vf).transpose(1, 2).reshape(B, H, W, C)
        else:
            K = neighbors.numel() // (H * W)
            k_n = k.reshape(B, H * Wk, nh, dh)[:, neighbors].reshape(B, H, W, K, nh, dh)
            v_n = v.reshape(B, H * Wk, nh, dh)[:, neighbors].reshape(B, H, W, K, nh, dh)
            w = softmax_f32_math(torch.einsum("bhwnd,bhwknd->bhwnk", q, k_n))
            out = torch.einsum("bhwnk,bhwknd->bhwnd", w, v_n).reshape(B, H, W, C)
        return x + dense(self.out_proj, out)

    def _halo_neighbors(self, H: int, W: int, device) -> torch.Tensor:
        """:func:`halo_neighborhood_indices` for a shard of W columns, made
        once per shape and device."""
        key = (H, W, str(device))
        if key not in self._halo_cache:
            idx = halo_neighborhood_indices(H, W, *self.kernel_size)
            self._halo_cache[key] = torch.as_tensor(idx.reshape(-1), device=device)
        return self._halo_cache[key]


class GEGLU(nn.Module):
    """Linear to 2·features (no bias) → a · GELU(gate), exact GELU."""

    def __init__(self, dim: int, features: int):
        super().__init__()
        self.dense_0 = nn.Linear(dim, 2 * features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = dense(self.dense_0, x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="none")


class FeedForward(nn.Module):
    """AdaRMSNorm → GEGLU → Linear (no bias), residual."""

    def __init__(self, dim: int, emb_dim: int, mid_dim: int):
        super().__init__()
        self.adarms = AdaRMSNorm(dim, emb_dim)
        self.gegelu = GEGLU(dim, mid_dim)
        self.linear = nn.Linear(mid_dim, dim, bias=False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return x + dense(self.linear, self.gegelu(self.adarms(x, emb)))


class HDiTBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        emb_dim: int,
        num_heads: int,
        coords: torch.Tensor,
        kernel_size: tuple[int, int] | None,
        rope_max_harmonics: tuple[int, int],
        mlp_ratio: float,
    ):
        super().__init__()
        self.attn = SelfAttention(dim, emb_dim, num_heads, coords, rope_max_harmonics, kernel_size)
        self.ffn = FeedForward(dim, emb_dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return self.ffn(self.attn(x, emb), emb)


class MappingNetwork(nn.Module):
    """RMSNorm → ``depth`` residual (RMSNorm → GEGLU → Linear) → RMSNorm."""

    def __init__(self, dim: int, mid_dim: int, depth: int = 2):
        super().__init__()
        self.depth = depth
        self.norm_in = RMSNorm(dim)
        for i in range(depth):
            self.add_module(f"mlp{i}_norm", RMSNorm(dim))
            self.add_module(f"mlp{i}_gegelu", GEGLU(dim, mid_dim))
            self.add_module(f"mlp{i}_linear", nn.Linear(mid_dim, dim, bias=False))
        self.norm_out = RMSNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm_in(x)
        for i in range(self.depth):
            h = self.get_submodule(f"mlp{i}_norm")(x)
            h = self.get_submodule(f"mlp{i}_gegelu")(h)
            x = x + dense(self.get_submodule(f"mlp{i}_linear"), h)
        return self.norm_out(x)


def _pool2(c: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(H, W, 2) → (H/ph, W/pw, 2), the mean of each ph × pw patch."""
    H, W, _ = c.shape
    return c.reshape(H // ph, ph, W // pw, pw, 2).mean(dim=(1, 3))


class HDiT(nn.Module):
    """``forward(x (B, H, W, C), t (B,))`` → (B, H, W, out).

    ``in_channels`` and ``resolution`` come from the data; the ray-angle
    switches are accepted for the factory and not read (the token
    coordinates are polar by construction, as in the JAX package), nor are
    ``dilation`` and ``ring`` (the neighbourhood always wraps on W)."""

    def __init__(
        self,
        resolution: tuple[int, int],
        in_channels: int,
        out_channels: int | None = None,
        base_channels: int = 128,
        time_embed_channels: int = 256,
        patch_size: tuple[int, int] = (1, 4),
        window_size: tuple[int, int] = (3, 9),
        depths: Sequence[int] = (2, 2, 2, 2),
        num_heads: Sequence[int] = (2, 4, 8, 16),
        dilation: Sequence[int] = (1, 1, 1, 1),
        mlp_ratio: float = 3.0,
        dropout: float = 0.0,
        mapping_depth: int = 2,
        positional_embedding: str | None = "learnable_embedding",
        ring: bool = True,
        rff_std: float = 1.0,
        use_ray_angle_coords: bool = False,
        fov_up: float = 10.0,
        fov_down: float = -30.0,
    ):
        super().__init__()
        H, W = resolution
        ph, pw = patch_size
        th, tw = H // ph, W // pw
        self.resolution, self.patch_size = (H, W), (ph, pw)
        self.depths = tuple(depths)
        self.out_channels = out_channels or in_channels
        temb = time_embed_channels
        C = base_channels

        self.register_buffer("rff_freqs", torch.randn(temb // 2) * rff_std)
        self.rff_linear = nn.Linear(temb, temb, bias=False)
        self.timestep_mapping = MappingNetwork(temb, int(temb * mlp_ratio), mapping_depth)
        self.tokenizer = nn.Conv2d(in_channels, C, (ph, pw), stride=(ph, pw), bias=False)
        self.spatial_pe = (
            nn.Parameter(torch.zeros(1, th, tw, C)) if positional_embedding == "learnable_embedding" else None
        )

        c = _pool2(torch.as_tensor(enc.generate_polar_coords(H, W), dtype=torch.float32), ph, pw)
        if positional_embedding not in ("learnable_embedding", None):
            # an absolute embedding: the encoded token coordinates (float64 on
            # the host), a bias-free projection and a mapping network
            pemb = enc.encode_coords(c.numpy().astype(np.float64), positional_embedding, (th, tw))
            self.register_buffer("pos_encoding", torch.as_tensor(pemb, dtype=torch.float32), persistent=False)
            self.ape_linear = nn.Linear(pemb.shape[-1], C, bias=False)
            self.spatial_mapping = MappingNetwork(C, int(C * mlp_ratio), mapping_depth)
        else:
            self.pos_encoding = None
        max_h = (max(th // 2, 1), max(tw // 2, 1))
        levels = len(self.depths) - 1
        self.levels = levels

        def harm(i):
            return (max(max_h[0] >> i, 1), max(max_h[1] >> i, 1))

        coords, widths = [], []
        for i in range(levels):
            coords.append(c)
            widths.append(C)
            for j in range(self.depths[i]):
                self.add_module(f"down_{i}_{j}", HDiTBlock(
                    C, temb, num_heads[i], c, tuple(window_size), harm(i), mlp_ratio))
            c = _pool2(c, 2, 2)
            self.add_module(f"merge_{i}", nn.Linear(4 * C, 2 * C, bias=False))
            C *= 2
        for j in range(self.depths[-1]):
            self.add_module(f"mid_{j}", HDiTBlock(C, temb, num_heads[-1], c, None, harm(levels), mlp_ratio))
        for i in reversed(range(levels)):
            self.add_module(f"expand_{i}_linear", nn.Linear(C, 2 * C, bias=False))
            self.register_parameter(f"expand_{i}_alpha", nn.Parameter(torch.zeros(C // 2)))
            C //= 2
            for j in range(self.depths[i]):
                self.add_module(f"up_{i}_{j}", HDiTBlock(
                    C, temb, num_heads[i], coords[i], tuple(window_size), harm(i), mlp_ratio))
        self.detok_norm = RMSNorm(C)
        self.detok_linear = nn.Linear(C, self.out_channels * ph * pw, bias=False)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """Random Fourier features of t, projected and mapped; the
        frequencies rounded to the weights' dtype."""
        freqs = self.rff_freqs.to(self.rff_linear.weight.dtype)
        ang = t[:, None] * (2 * math.pi * freqs)[None]
        emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)
        return self.timestep_mapping(dense(self.rff_linear, emb))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        t = t.expand(B) if t.ndim == 0 else t
        ph, pw = self.patch_size
        emb = self.time_embedding(t)

        h = self.tokenizer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        th, tw = h.shape[1:3]  # this rank's token columns under the azimuth axis
        mesh = azimuth()
        if self.spatial_pe is not None:
            pe = self.spatial_pe
            h = h + (pe if mesh is None else pe[:, :, mesh.columns(pe.shape[2])])
        elif self.pos_encoding is not None:
            pos = self.pos_encoding if mesh is None else self.pos_encoding[:, mesh.columns(self.pos_encoding.shape[1])]
            pemb = dense(self.ape_linear, pos.to(h.dtype))
            h = h + self.spatial_mapping(pemb)[None]
        skips = []
        for i in range(self.levels):
            for j in range(self.depths[i]):
                h = self.get_submodule(f"down_{i}_{j}")(h, emb)
            skips.append(h)
            Bh, Hh, Wh, Ch = h.shape  # patch merging
            h = h.reshape(Bh, Hh // 2, 2, Wh // 2, 2, Ch).permute(0, 1, 3, 2, 4, 5)
            h = dense(self.get_submodule(f"merge_{i}"), h.reshape(Bh, Hh // 2, Wh // 2, 4 * Ch))
        for j in range(self.depths[-1]):
            h = self.get_submodule(f"mid_{j}")(h, emb)
        for i in reversed(range(self.levels)):
            h_skip = skips.pop()
            Bh, Hh, Wh, Ch = h.shape  # patch expanding, lerp onto the skip
            h = dense(self.get_submodule(f"expand_{i}_linear"), h).reshape(Bh, Hh, Wh, 2, 2, Ch // 2)
            h = h.permute(0, 1, 3, 2, 4, 5).reshape(Bh, Hh * 2, Wh * 2, Ch // 2)
            a = torch.sigmoid(getattr(self, f"expand_{i}_alpha"))
            h = h_skip + (h - h_skip) * a
            for j in range(self.depths[i]):
                h = self.get_submodule(f"up_{i}_{j}")(h, emb)

        h = dense(self.detok_linear, self.detok_norm(h)).reshape(B, th, tw, ph, pw, self.out_channels)
        return h.permute(0, 1, 3, 2, 4, 5).reshape(B, th * ph, tw * pw, self.out_channels)
