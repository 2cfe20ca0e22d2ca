"""ObjectAwareCrossAttention over a split image strip and layout strip.

Port of the TPU kernel ``_oaca_kernel`` of the JAX package
(``ops/pallas_attention.py``, wrappers ``oaca_attention`` / ``_oaca_call``).
The CUDA kernel is ``csrc/oaca.cu``; :func:`oaca_attention_plain` beside it is
the same function in plain PyTorch (the JAX package's ``_oaca_unfused``).
:func:`oaca_attention` takes the plain version for tensors on the CPU and
launches the kernel for tensors on the card; it never falls back from one to
the other.

On the card the kernel is differentiable through :class:`OacaAttention`:
the forward launches the kernel and keeps only its operands, the backward
is :func:`oaca_attention_backward`, autograd of the plain version recomputed
in float32 (the JAX package's ``_oaca_bwd``: ``pallas_call`` has no
transpose rule, so its backward is the XLA recompute too).  No path of the
JAX package takes OACA's forward-mode derivative, so it has no forward-mode
rule here: an operand that carries a tangent raises.

While ``torch.export`` traces it with grad off, the wrapper calls the
operator ``torch.ops.lidarcrafter_torch.oaca_forward`` (:func:`oaca_op`), on
either device: its CUDA implementation is :func:`launch`, its CPU
implementation the plain version, and its fake rule gives the kernel's
output layout, so that an exported sampler carries the kernel
(``serving/export.py``).  An eager call launches directly, with no
dispatcher in its host time.
"""

from __future__ import annotations

import ctypes

import torch

from . import loader

launches = loader.LaunchCounter("oaca")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (content, positional, value) head dims the kernel runs: 32^3 for the
# v1-v6 and auto-reg stacks, 64^3 for the v0 LayoutUnet, and positional
# strips of half and twice the content width on 32-channel heads
# (channels_scale_for_positional_embedding 0.5 and 2)
HEAD_DIMS = ((32, 32, 32), (64, 64, 64), (32, 16, 32), (32, 64, 32))
_MAX_L2 = 64  # layout tokens: one shared-memory key tile


def oaca_attention_plain(q_c, ipe, k_c, k_l, v_c, v_l, *, scale: float) -> torch.Tensor:
    """softmax([q_c|ipe]·s · [[k_c|ipe]; k_l]ᵀ·s) · [v_c; v_l] in float32,
    cast to ``q_c.dtype``.  Operands are (B, heads, L, d)."""
    q_img = torch.cat([q_c, ipe], dim=-1)
    k_img = torch.cat([k_c, ipe], dim=-1)
    k_mix = torch.cat([k_img, k_l], dim=2).float() * scale
    v_mix = torch.cat([v_c, v_l], dim=2).float()
    logits = torch.einsum("bhtc,bhsc->bhts", q_img.float() * scale, k_mix)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsc->bhtc", w, v_mix).to(q_c.dtype)


def oaca_attention_backward(ops, g: torch.Tensor, *, scale: float) -> tuple[torch.Tensor, ...]:
    """Gradients of :func:`oaca_attention` with respect to its six operands
    ``ops`` = (q_c, ipe, k_c, k_l, v_c, v_l) for the output gradient ``g``
    (any strides): autograd of the plain version recomputed in float32 from
    the operands, each gradient cast to its operand's dtype.  Nothing of
    the recompute outlives the call."""
    with torch.enable_grad():
        xs = [t.detach().float().requires_grad_() for t in ops]
        out = oaca_attention_plain(*xs, scale=scale)
        grads = torch.autograd.grad(out, xs, g.float())
    return tuple(d.to(t.dtype) for d, t in zip(grads, ops))


def check_head_dims(dc: int, dp: int, dv: int) -> None:
    """Raise ``ValueError`` unless the kernel has an instantiation for the
    head dims (dc, dp, dv): the wrapper checks this before a launch on the
    card and never takes the plain version for a CUDA tensor instead."""
    if (dc, dp, dv) not in HEAD_DIMS:
        raise ValueError(f"oaca_attention kernel is built for head dims {HEAD_DIMS}, got {(dc, dp, dv)}")


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _check(q_c, ipe, k_c, k_l, v_c, v_l, scale: float) -> None:
    """Raise unless the kernel takes these operands (shapes, dtypes,
    strides, head dims and scale; nothing that reads a pointer)."""
    B, H, Lq, dc = q_c.shape
    dp, L2, dv = ipe.shape[-1], k_l.shape[2], v_c.shape[-1]
    ops = (q_c, ipe, k_c, k_l, v_c, v_l)
    if any(t.device != q_c.device for t in ops) or q_c.device.type != "cuda":
        raise ValueError("oaca_attention: operands must all be on one CUDA device")
    if any(t.dtype != q_c.dtype for t in ops) or q_c.dtype not in _DTYPE_CODES:
        raise TypeError("oaca_attention kernel needs one dtype, float32 or bfloat16")
    check_head_dims(dc, dp, dv)
    expect = {
        "ipe": (ipe, (B, H, Lq, dp)), "k_c": (k_c, (B, H, Lq, dc)),
        "k_l": (k_l, (B, H, L2, dc + dp)), "v_c": (v_c, (B, H, Lq, dv)),
        "v_l": (v_l, (B, H, L2, dv)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"oaca_attention: {name} has shape {tuple(t.shape)}, expected {shape}")
    if any(t.stride(-1) != 1 for t in ops):
        raise ValueError("oaca_attention kernel needs a contiguous last dimension")
    if L2 > _MAX_L2 or B * H > 65535:
        raise ValueError(f"oaca_attention kernel takes L2 <= {_MAX_L2} and B*heads <= 65535")
    if not scale > 0:
        raise ValueError(f"oaca_attention kernel takes a positive scale, got {scale}")


def _out_like(q_c: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B, heads, Lq, dv) result laid out (B, Lq, heads, dv) in
    memory, as the kernel writes it."""
    B, H, Lq, _ = q_c.shape
    return q_c.new_empty_strided((B, H, Lq, dv), (Lq * H * dv, dv, H * dv, 1))


def launch(q_c, ipe, k_c, k_l, v_c, v_l, *, scale: float) -> torch.Tensor:
    """One launch of the kernel on plain operands (no autograd, no
    tangent); checks them, their alignment (which reads their pointers)
    included."""
    _check(q_c, ipe, k_c, k_l, v_c, v_l, scale)
    B, H, Lq, dc = q_c.shape
    dp, L2, dv = ipe.shape[-1], k_l.shape[2], v_c.shape[-1]
    ops = (q_c, ipe, k_c, k_l, v_c, v_l)
    loader.check_aligned("oaca_attention", *ops)
    out = _out_like(q_c, dv)
    args = loader.OacaArgs(
        *(t.data_ptr() for t in ops), out.data_ptr(),
        *((ctypes.c_int64 * 3)(*_strides(t)) for t in (*ops, out)),
        B, H, Lq, L2, float(scale) ** 2,
    )
    err = loader.library("oaca").oaca_forward(
        args, _DTYPE_CODES[q_c.dtype], dc, dp, dv,
        torch.cuda.current_stream(q_c.device).cuda_stream,
    )
    loader.check(err, "oaca_forward")
    launches.n += 1
    return out


@torch.library.custom_op("lidarcrafter_torch::oaca_forward", mutates_args=(), device_types="cuda")
def oaca_op(q_c: torch.Tensor, ipe: torch.Tensor, k_c: torch.Tensor, k_l: torch.Tensor,
            v_c: torch.Tensor, v_l: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel as an operator that ``torch.export`` records: one
    :func:`launch` on the card, :func:`oaca_attention_plain` on the CPU,
    both laid out as the kernel writes its result."""
    return launch(q_c, ipe, k_c, k_l, v_c, v_l, scale=scale)


@oaca_op.register_kernel("cpu")
def _oaca_op_cpu(q_c, ipe, k_c, k_l, v_c, v_l, scale):
    return _out_like(q_c, v_c.shape[-1]).copy_(oaca_attention_plain(q_c, ipe, k_c, k_l, v_c, v_l, scale=scale))


@oaca_op.register_fake
def _oaca_op_fake(q_c, ipe, k_c, k_l, v_c, v_l, scale):
    return _out_like(q_c, v_c.shape[-1])


class OacaAttention(torch.autograd.Function):
    """The kernel's forward with :func:`oaca_attention_backward` as its
    backward; ``apply(scale, q_c, ipe, k_c, k_l, v_c, v_l)``."""

    @staticmethod
    def forward(ctx, scale, *ops):
        ctx.scale = scale
        ctx.save_for_backward(*ops)
        return launch(*ops, scale=scale)

    @staticmethod
    def backward(ctx, g):
        return (None, *oaca_attention_backward(ctx.saved_tensors, g, scale=ctx.scale))


def oaca_attention(q_c, ipe, k_c, k_l, v_c, v_l, *, scale: float) -> torch.Tensor:
    """Joint softmax attention of image queries over image and layout keys.

    Args (all (B, heads, L, d), one dtype):
      q_c, k_c, v_c: per-head image content projections, L = Lq = H·W.
      ipe: per-head image-patch positional embedding, concatenated onto both
        q_c and k_c.
      k_l, v_l: layout strip, L2 tokens; k_l is already [k_content | pe].
      scale: the per-operand 1/√√(dc + dp) factor (applied as scale² to the
        logits).

    On the card the head dims (dc, dp, dv) must be one of ``HEAD_DIMS``:
    (32, 32, 32), (64, 64, 64), (32, 16, 32) or (32, 64, 32) (else
    ``ValueError``).
    Any strides are taken as long as the last dimension is contiguous and
    the pointers and strides are whole 16-byte pieces (else ``ValueError``).
    The kernel runs its products on the tensor cores: bf16 ``mma.sync``, or
    3xTF32 for float32.  Returns (B, heads, Lq, dv) in the operands' dtype;
    on the card its memory is laid out (B, Lq, heads, dv), so that merging
    the heads back into channels is free.  With grad enabled and an operand
    that requires grad, the result carries :class:`OacaAttention`'s
    backward (on the CPU: autograd of the plain version); otherwise the
    kernel is launched directly, or, while ``torch.export`` traces the
    call, the operator :func:`oaca_op` is recorded.  An operand that
    carries a forward-mode tangent
    (``torch.func.jvp``, ``forward_ad``) raises ``NotImplementedError`` on
    the card.
    """
    ops = (q_c, ipe, k_c, k_l, v_c, v_l)
    autograd = torch.is_grad_enabled() and any(t.requires_grad for t in ops)
    tangent = loader.has_tangent(*ops)
    if not (autograd or tangent) and loader.tracing():
        return torch.ops.lidarcrafter_torch.oaca_forward(*ops, float(scale))
    if q_c.device.type == "cpu":
        return oaca_attention_plain(*ops, scale=scale)
    if q_c.device.type != "cuda":
        raise ValueError("oaca_attention: operands must all be on one CUDA device")
    if tangent:
        raise NotImplementedError("oaca_attention has no forward-mode rule: an operand carries a tangent "
                                  "(torch.func.jvp / forward_ad), which the kernel would drop")
    if autograd:
        return OacaAttention.apply(float(scale), *ops)
    return launch(*ops, scale=scale)
