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
"""

from __future__ import annotations

import ctypes

import torch

from . import loader

launches = loader.LaunchCounter("attention")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims up to 128 run in one padded shared tile; up to 512 in 128-wide
# chunks of dqk and slices of dv (csrc/attention.cu, attention_fwd_wide_kernel)
_MAX_HEAD_DIM = 512


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


def launch(q, k, v, *, scale: float, kv_len: int) -> torch.Tensor:
    """One launch of the kernel on checked plain operands (no autograd, no
    tangent); checks their alignment, which reads their pointers."""
    B, H, Lq, dqk = q.shape
    Lkv, dv = k.shape[2], v.shape[-1]
    ops = (q, k, v)
    loader.check_aligned("attention", *ops)
    out = torch.empty((B, Lq, H, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    args = loader.AttnArgs(
        *(t.data_ptr() for t in ops), out.data_ptr(),
        *((ctypes.c_int64 * 3)(*_strides(t)) for t in (*ops, out)),
        B, H, Lq, Lkv, kv_len, dqk, dv, float(scale),
    )
    err = loader.library("attention").attention_forward(
        args, _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream
    )
    loader.check(err, "attention_forward")
    launches.n += 1
    return out


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
    Head dims go up to 512 (``ValueError`` above): up to 128 in one padded
    tile, above it (OpenAIUNet's single heads of 256 and 512) in 128-wide
    chunks, which recompute the logits once per 128 columns of dv.
    The kernel runs its products on the tensor cores: bf16 ``mma.sync``, or
    3xTF32 for float32.  Returns (B, heads, Lq, dv) in q's dtype; on the
    card its memory is laid out (B, Lq, heads, dv), so that merging the
    heads back into channels is free.  An operand that carries a
    forward-mode tangent (``torch.func.jvp``, ``forward_ad``), or, with grad
    enabled, one that requires grad, sends the call through
    :class:`Attention`; otherwise the kernel is launched directly.
    """
    B, H, Lq, dqk = q.shape
    Lkv, dv = k.shape[2], v.shape[-1]
    kv_len = Lkv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= Lkv:
        raise ValueError(f"attention: kv_len {kv_len} outside [1, {Lkv}]")
    if tuple(k.shape) != (B, H, Lkv, dqk) or tuple(v.shape[:3]) != (B, H, Lkv):
        raise ValueError(f"attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    ops = (q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, kv_len=kv_len)
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
    if not scale > 0:
        raise ValueError(f"attention kernel takes a positive scale, got {scale}")
    if loader.has_tangent(*ops) or (torch.is_grad_enabled() and any(t.requires_grad for t in ops)):
        return Attention.apply(float(scale), kv_len, q, k, v)
    return launch(q, k, v, scale=scale, kv_len=kv_len)
