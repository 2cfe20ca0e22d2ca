"""Softmax attention over (batch, heads, L, d) operands.

Port of the TPU kernel ``_attn_kernel`` of the JAX package
(``ops/pallas_attention.py``, wrappers ``flash_attention`` /
``attention_bhld``).  The CUDA kernel is ``csrc/attention.cu``;
:func:`attention_plain` beside it is the same function in plain PyTorch.
:func:`attention` takes the plain version for tensors on the CPU and launches
the kernel for tensors on the card; it never falls back from one to the
other.

Unlike the TPU kernel, which expected q and k pre-scaled by the caller, the
scale is applied to the f32 logits, so the blocks pass their projections as
they come.

On the card the kernel is differentiable through :class:`Attention`: the
forward launches the kernel and keeps only q, k and v, the backward is
:func:`attention_backward`, the JAX package's ``_flash_attention_bwd``
(float32 einsums that recompute the softmax; ``pallas_call`` has no
transpose rule), and the forward-mode rule is :func:`attention_jvp`, the
plain version's tangent in float32 from the same recompute.  The MeanFlow
loss takes ``torch.func.jvp`` through the attention blocks; an operand that
carries a tangent always goes through the Function, so no tangent reaches a
bare launch.

While ``torch.export`` traces it with grad off and no tangent, the wrapper
calls the operator ``torch.ops.lidarcrafter_torch.attention_forward``
(:func:`attention_op`), on either device: its CUDA implementation is
:func:`launch`, its CPU implementation the plain version, and its fake rule
gives the kernel's output layout, so that an exported sampler carries the
kernel (``serving/export.py``).  An eager call launches directly, with no
dispatcher in its host time.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import loader

launches = loader.LaunchCounter("attention")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# every head dim runs on the warp-specialised TMA + wgmma core
# (csrc/hopper_flash.cuh), except where ``route`` keeps the cp.async +
# mma.sync loader (head dims up to 128), which ``launch(on=...)`` also
# times beside it on the same operands
_NARROW_HEAD_DIM, _MAX_HEAD_DIM = 128, 512


@dataclasses.dataclass(frozen=True)
class Plan:
    """Mirror of ``csrc/attention.cu::core_plan``: whether the two consumer
    warpgroups split a 64-row query tile (else each owns 64 of 128 rows),
    the key tile ``bk``, a consumer's O width ``nv``, the blocks an SM and
    the shared-memory plan."""

    split: bool
    bk: int
    nv: int
    blocks: int
    layout: loader.HopperLayout


def plan(dqk: int, dv: int, dtype: torch.dtype) -> Plan:
    """The core's tiling for head dims (dqk, dv).  Up to 128: not split, both
    dims padded to d = 32, 64 or 128; bf16 at 32 in 64-byte chunks with
    64-key tiles and two blocks an SM, at 64 and 128 128-key tiles; float32
    64-key tiles.  Wider: bf16 up to 256 not split with 80-key tiles, the
    rest split."""
    f32 = dtype == torch.float32
    e = 4 if f32 else 2
    d = max(dqk, dv)
    if d <= _NARROW_HEAD_DIM:
        dp = 32 if d <= 32 else 64 if d <= 64 else 128
        row = e * dp
        bk, blocks = (64 if f32 or dp == 32 else 128), (2 if not f32 and dp == 32 else 1)
        out = 2 * -(-row // loader.CHUNK) * 64 * loader.CHUNK  # both consumers' O, staged for the TMA store
        return Plan(False, bk, dp, blocks, loader.hopper_layout(False, bk, row, row, out, blocks))
    nqc = -(-dqk * e // loader.CHUNK)
    if not f32 and dqk <= 256 and dv <= 256:
        split, nv, bk = False, 128 if dv <= 128 else 256, 80
    else:
        split, nv, bk = True, 128 if (dv + 1) // 2 <= 128 else 256, 32
        half = 2 * nv * e  # both halves' V row
        if f32 and (nv == 256 or loader.hopper_layout(True, 32, nqc * loader.CHUNK, half, half * 64).stages < 2):
            bk = 16
    v_row = (2 if split else 1) * nv * e
    return Plan(split, bk, nv, 1, loader.hopper_layout(split, bk, nqc * loader.CHUNK, v_row, 2 * nv * e * 64))


def takes_mma(dqk: int, dv: int, dtype: torch.dtype) -> bool:
    """Whether a call stays on the cp.async + mma.sync loader: a fixed rule,
    ``csrc/attention.cu::takes_mma``, where the core measured slower:
    float32 at head dims up to 128 (3xTF32 from the core's tiles splits each
    K / V fragment for one m16 tile a warp, the loader's warps for two)."""
    return dtype == torch.float32 and max(dqk, dv) <= _NARROW_HEAD_DIM


def route(dqk: int, dv: int, dtype: torch.dtype) -> str:
    """The route the kernel takes for head dims (dqk, dv) in ``dtype``:
    ``wgmma bf16`` / ``tma mma 3xTF32`` (the warp-specialised TMA core), or
    ``mma bf16`` / ``mma 3xTF32`` (the cp.async loader) where
    :func:`takes_mma` keeps a call there."""
    return (loader.MMA_ROUTES if takes_mma(dqk, dv, dtype) else loader.CORE_ROUTES)[dtype]


def attention_plain(q, k, v, *, scale: float, kv_len: int | None = None) -> torch.Tensor:
    """softmax(scale · q·kᵀ) · v over the first ``kv_len`` keys, in float32,
    cast to ``q.dtype``.  Operands are (B, heads, L, d)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        logits[..., kv_len:] = -torch.inf
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def attention_backward(q, k, v, g, *, scale: float, kv_len: int | None = None):
    """Gradients (dq, dk, dv) of :func:`attention` for the output gradient
    ``g`` (any strides), in float32 from a recomputed softmax, each cast to
    its operand's dtype.  The JAX package's ``_flash_attention_bwd`` with
    the scale on the logits: dq and dk carry it, as the chain rule through
    its caller's pre-scaled q and k gives."""
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    logits = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        logits[..., kv_len:] = -torch.inf
    w = torch.softmax(logits, dim=-1)
    del logits
    dv = torch.einsum("bhqk,bhqd->bhkd", w, g32)
    dw = torch.einsum("bhqd,bhkd->bhqk", g32, v32)
    dlogits = (dw - (dw * w).sum(dim=-1, keepdim=True)).mul_(w).mul_(scale)
    del dw, w
    dq = torch.einsum("bhqk,bhkd->bhqd", dlogits, k32)
    dk = torch.einsum("bhqk,bhqd->bhkd", dlogits, q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_jvp(q, k, v, dq, dk, dv, *, scale: float, kv_len: int | None = None):
    """Tangent of :func:`attention` at (q, k, v) along (dq, dk, dv), each
    None for a zero tangent, in float32 from a recomputed softmax P and cast
    to q's dtype: dS = scale·(dq·kᵀ + q·dkᵀ), dP = P ⊙ (dS − Σ P ⊙ dS), and
    the tangent is dP·v + P·dv.  It is laid out (B, Lq, heads, dv) in
    memory, as the kernel's output is.  Closed form rather than a nested
    ``torch.func.jvp``: forward-mode AD does not nest inside a
    ``forward_ad`` rule."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        logits[..., kv_len:] = -torch.inf
    w = torch.softmax(logits, dim=-1)
    del logits
    out = q32.new_zeros((q.shape[0], q.shape[2], q.shape[1], v.shape[-1]))
    if dq is not None or dk is not None:
        ds = torch.einsum("bhqd,bhkd->bhqk", dq.float(), k32) if dq is not None else 0.0
        if dk is not None:
            ds = ds + torch.einsum("bhqd,bhkd->bhqk", q32, dk.float())
        dw = (ds - (ds * w).sum(dim=-1, keepdim=True)).mul_(w).mul_(scale)
        out += torch.einsum("bhqk,bhkd->bqhd", dw, v32)
    if dv is not None:
        out += torch.einsum("bhqk,bhkd->bqhd", w, dv.float())
    return out.to(q.dtype).transpose(1, 2)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _check(q, k, v, scale: float, kv_len: int) -> None:
    """Raise unless the kernel takes these operands (shapes, dtypes,
    strides, head dims and scale; nothing that reads a pointer)."""
    B, H, Lq, dqk = q.shape
    Lkv, dv = k.shape[2], v.shape[-1]
    ops = (q, k, v)
    if any(t.device != q.device for t in ops) or q.device.type != "cuda":
        raise ValueError("attention: operands must all be on one CUDA device")
    if any(t.dtype != q.dtype for t in ops) or q.dtype not in _DTYPE_CODES:
        raise TypeError("attention kernel needs one dtype, float32 or bfloat16")
    if max(dqk, dv) > _MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes head dims <= {_MAX_HEAD_DIM}, got {(dqk, dv)}")
    if any(t.stride(-1) != 1 for t in ops):
        raise ValueError("attention kernel needs a contiguous last dimension")
    if Lq == 0 or B * H > 65535:
        raise ValueError("attention kernel takes Lq >= 1 and B*heads <= 65535")
    if not all(loader.tma_addressable(t) for t in ops):
        raise ValueError("attention kernel's TMA route takes rows < 2^31 and strides < 2^40 bytes")
    if not scale > 0:
        raise ValueError(f"attention kernel takes a positive scale, got {scale}")


def _out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B, heads, Lq, dv) result laid out (B, Lq, heads, dv) in
    memory, as the kernel writes it."""
    B, H, Lq, _ = q.shape
    return q.new_empty_strided((B, H, Lq, dv), (Lq * H * dv, dv, H * dv, 1))


def launch(q, k, v, *, scale: float, kv_len: int, on: str | None = None) -> torch.Tensor:
    """One launch of the kernel on plain operands (no autograd, no
    tangent); checks them, their alignment (which reads their pointers)
    included.  The route is :func:`route`'s, or with ``on`` ("core" or
    "mma") that one: the two side by side on the same operands, for the
    kernel table (``chip_smoke.py``, ``scripts/kernel_pace.py``)."""
    _check(q, k, v, scale, kv_len)
    B, H, Lq, dqk = q.shape
    Lkv, dv = k.shape[2], v.shape[-1]
    ops = (q, k, v)
    loader.check_aligned("attention", *ops)
    out = _out_like(q, dv)
    args = loader.AttnArgs(
        *(t.data_ptr() for t in ops), out.data_ptr(),
        *((ctypes.c_int64 * 3)(*_strides(t)) for t in (*ops, out)),
        B, H, Lq, Lkv, kv_len, dqk, dv, float(scale),
    )
    lib, stream = loader.library("attention"), torch.cuda.current_stream(q.device).cuda_stream
    if on is None:
        err = lib.attention_forward(args, _DTYPE_CODES[q.dtype], stream)
    elif on == "mma" and max(dqk, dv) > _NARROW_HEAD_DIM:
        raise ValueError(f"attention's mma.sync loader takes head dims <= {_NARROW_HEAD_DIM}")
    else:
        err = lib.attention_forward_on(args, _DTYPE_CODES[q.dtype], ("core", "mma").index(on), stream)
    loader.check(err, "attention_forward")
    launches.n += 1
    return out


@torch.library.custom_op("lidarcrafter_torch::attention_forward", mutates_args=(), device_types="cuda")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, kv_len: int) -> torch.Tensor:
    """The kernel as an operator that ``torch.export`` records: one
    :func:`launch` on the card, :func:`attention_plain` on the CPU, both
    laid out as the kernel writes its result."""
    return launch(q, k, v, scale=scale, kv_len=kv_len)


@attention_op.register_kernel("cpu")
def _attention_op_cpu(q, k, v, scale, kv_len):
    return _out_like(q, v.shape[-1]).copy_(attention_plain(q, k, v, scale=scale, kv_len=kv_len))


@attention_op.register_fake
def _attention_op_fake(q, k, v, scale, kv_len):
    return _out_like(q, v.shape[-1])


class Attention(torch.autograd.Function):
    """The kernel's forward with :func:`attention_backward` as its backward
    and :func:`attention_jvp` as its forward-mode rule; ``apply(scale,
    kv_len, q, k, v)``.  The forward takes no ctx, so ``torch.func``
    transforms hand it the plain operands."""

    @staticmethod
    def forward(scale, kv_len, q, k, v):
        return launch(q, k, v, scale=scale, kv_len=kv_len)

    @staticmethod
    def setup_context(ctx, inputs, output):
        scale, kv_len, q, k, v = inputs
        ctx.scale, ctx.kv_len = scale, kv_len
        ctx.save_for_backward(q, k, v)
        ctx.save_for_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        grads = attention_backward(*ctx.saved_tensors, g, scale=ctx.scale, kv_len=ctx.kv_len)
        return (None, None, *grads)

    @staticmethod
    def jvp(ctx, _scale, _kv_len, dq, dk, dv):
        return attention_jvp(*ctx.saved_tensors, dq, dk, dv, scale=ctx.scale, kv_len=ctx.kv_len)


def attention(q, k, v, *, scale: float, kv_len: int | None = None) -> torch.Tensor:
    """Softmax attention of ``q`` over the first ``kv_len`` keys of ``k``/``v``.

    Args (all one dtype, float32 or bfloat16 on the card):
      q: (B, heads, Lq, dqk).
      k: (B, heads, Lkv, dqk).
      v: (B, heads, Lkv, dv).
      scale: factor on the f32 logits.
      kv_len: number of real keys (default all Lkv); the rest are masked.

    Any strides are taken as long as the last dimension is contiguous and
    the pointers, strides and head dims are whole 16-byte pieces (else
    ``ValueError``), so per-head views of a fused projection need no copy.
    Head dims go up to 512 (``ValueError`` above), on the warp-specialised
    TMA core, bf16 on ``wgmma`` and float32 on 3xTF32 ``mma.sync``, the
    logits computed once for the whole dv (:func:`plan`); float32 at head
    dims up to 128 on the cp.async + mma.sync loader (:func:`route`).
    Returns (B, heads, Lq, dv) in q's dtype; on the card its memory is laid
    out (B, Lq, heads, dv), so that merging the heads back into channels is
    free.  An operand that carries a
    forward-mode tangent (``torch.func.jvp``, ``forward_ad``), or, with grad
    enabled, one that requires grad, sends the call through
    :class:`Attention` (on the CPU: the plain version); otherwise the kernel
    is launched directly, or, while ``torch.export`` traces the call, the
    operator :func:`attention_op` is recorded.
    """
    B, H, Lq, dqk = q.shape
    Lkv, dv = k.shape[2], v.shape[-1]
    kv_len = Lkv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= Lkv:
        raise ValueError(f"attention: kv_len {kv_len} outside [1, {Lkv}]")
    if tuple(k.shape) != (B, H, Lkv, dqk) or tuple(v.shape[:3]) != (B, H, Lkv):
        raise ValueError(f"attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    ops = (q, k, v)
    autograd = loader.has_tangent(*ops) or (torch.is_grad_enabled() and any(t.requires_grad for t in ops))
    if not autograd and loader.tracing():
        return torch.ops.lidarcrafter_torch.attention_forward(q, k, v, float(scale), kv_len)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError("attention: operands must all be on one CUDA device")
    if autograd:
        return Attention.apply(float(scale), kv_len, q, k, v)
    return launch(q, k, v, scale=scale, kv_len=kv_len)
