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

Under the azimuth axis (``parallel/mesh.py``) a rank's queries are its
columns of the image and its image keys every rank's, gathered: the image
keys then have a length Lk of their own and positional rows ``ipe_k`` of
their own (the whole strip), while the queries keep ``ipe``, their own
columns of it.  Without ``ipe_k`` the keys are the queries' tokens (Lk =
Lq, ``ipe_k`` = ``ipe``) and the launch is the one-process launch.

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
import dataclasses

import torch

from . import loader

launches = loader.LaunchCounter("oaca")
# the launches among those whose image keys are not the queries' tokens (Lk != Lq)
gathered_launches = loader.LaunchCounter("oaca_gathered")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (content, positional, value) head dims the kernel runs: 32^3 for the
# v1-v6 and auto-reg stacks, 64^3 for the v0 LayoutUnet, and positional
# strips of half and twice the content width on 32-channel heads
# (channels_scale_for_positional_embedding 0.5 and 2); each takes image keys
# of any length Lk (gathered under the azimuth axis)
HEAD_DIMS = ((32, 32, 32), (64, 64, 64), (32, 16, 32), (32, 64, 32))
_MAX_L2 = 64  # layout tokens: one shared-memory key tile
# every head dims' instantiation runs on the warp-specialised TMA core
# (csrc/oaca.cu, Oaca), except where ``route`` keeps the 32-wide ones'
# cp.async + mma.sync loader, which ``launch(on=...)`` also times beside it
# on the same operands.


def takes_mma(dc: int, dp: int, dv: int, dtype: torch.dtype) -> bool:
    """Whether a call stays on the cp.async + mma.sync loader: a fixed rule,
    ``csrc/oaca.cu::takes_mma``, where the core measured slower: float32 at
    the 32-wide head dims (3xTF32 from the core's tiles splits each K / V
    fragment for one m16 tile a warp, the loader's warps for two)."""
    return dtype == torch.float32 and dc == 32


def route(dc: int, dp: int, dv: int, dtype: torch.dtype) -> str:
    """The route the kernel takes for head dims (dc, dp, dv) in ``dtype``:
    ``wgmma bf16`` / ``tma mma 3xTF32`` (the warp-specialised TMA core), or
    ``mma bf16`` / ``mma 3xTF32`` (the cp.async loader) where
    :func:`takes_mma` keeps a call there."""
    return (loader.MMA_ROUTES if takes_mma(dc, dp, dv, dtype) else loader.CORE_ROUTES)[dtype]


@dataclasses.dataclass(frozen=True)
class Plan:
    """Mirror of ``csrc/oaca.cu::oaca_plan``: the key tile ``bk``, the blocks
    an SM and the shared-memory plan."""

    bk: int
    blocks: int
    layout: loader.HopperLayout


def plan(dc: int, dp: int, dtype: torch.dtype) -> Plan:
    """The core's tiling for head dims (dc, dp, dc): 128 query rows a block,
    key tiles of [k_c | ipe_k] and v_c, as many stages as fit.  Each part of
    a q / k row is one 64-byte chunk where it is 64 bytes or narrower (bf16
    dp = 16 runs in dp = 32's build), else 128-byte chunks.  bf16 32³: 64
    keys a tile, two blocks an SM; the other bf16 builds 128 keys; float32
    64."""
    f32 = dtype == torch.float32
    e = 4 if f32 else 2
    if not f32 and dp == 16:
        dp = 32
    bk, blocks = (64, 2) if not f32 and (dc, dp) == (32, 32) else (64 if f32 else 128, 1)
    part = lambda n: loader.HALF if n * e <= loader.HALF else n * e  # noqa: E731
    out = 2 * -(-dc * e // loader.CHUNK) * 64 * loader.CHUNK  # both consumers' O, staged for the TMA store
    return Plan(bk, blocks, loader.hopper_layout(False, bk, part(dc) + part(dp), part(dc), out, blocks))


def oaca_attention_plain(q_c, ipe, k_c, k_l, v_c, v_l, *, scale: float, ipe_k=None) -> torch.Tensor:
    """softmax([q_c|ipe]·s · [[k_c|ipe_k]; k_l]ᵀ·s) · [v_c; v_l] in float32,
    cast to ``q_c.dtype``.  Operands are (B, heads, L, d); ``ipe_k`` is
    ``ipe`` when None."""
    q_img = torch.cat([q_c, ipe], dim=-1)
    k_img = torch.cat([k_c, ipe if ipe_k is None else ipe_k], dim=-1)
    k_mix = torch.cat([k_img, k_l], dim=2).float() * scale
    v_mix = torch.cat([v_c, v_l], dim=2).float()
    logits = torch.einsum("bhtc,bhsc->bhts", q_img.float() * scale, k_mix)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsc->bhtc", w, v_mix).to(q_c.dtype)


def oaca_attention_backward(ops, g: torch.Tensor, *, scale: float) -> tuple[torch.Tensor, ...]:
    """Gradients of :func:`oaca_attention` with respect to its operands
    ``ops`` = (q_c, ipe, k_c, k_l, v_c, v_l[, ipe_k]) for the output gradient
    ``g`` (any strides): autograd of the plain version recomputed in float32
    from the operands, each gradient cast to its operand's dtype.  Nothing
    of the recompute outlives the call."""
    with torch.enable_grad():
        xs = [t.detach().float().requires_grad_() for t in ops]
        out = oaca_attention_plain(*xs[:6], scale=scale, ipe_k=xs[6] if len(xs) > 6 else None)
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


def _check(q_c, ipe, k_c, k_l, v_c, v_l, scale: float, ipe_k) -> None:
    """Raise unless the kernel takes these operands (shapes, dtypes,
    strides, head dims and scale; nothing that reads a pointer)."""
    B, H, Lq, dc = q_c.shape
    dp, L2, dv, Lk = ipe.shape[-1], k_l.shape[2], v_c.shape[-1], k_c.shape[2]
    ops = (q_c, ipe, k_c, k_l, v_c, v_l, ipe_k)
    if any(t.device != q_c.device for t in ops) or q_c.device.type != "cuda":
        raise ValueError("oaca_attention: operands must all be on one CUDA device")
    if any(t.dtype != q_c.dtype for t in ops) or q_c.dtype not in _DTYPE_CODES:
        raise TypeError("oaca_attention kernel needs one dtype, float32 or bfloat16")
    check_head_dims(dc, dp, dv)
    expect = {
        "ipe": (ipe, (B, H, Lq, dp)), "k_c": (k_c, (B, H, Lk, dc)),
        "k_l": (k_l, (B, H, L2, dc + dp)), "v_c": (v_c, (B, H, Lk, dv)),
        "v_l": (v_l, (B, H, L2, dv)), "ipe_k": (ipe_k, (B, H, Lk, dp)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"oaca_attention: {name} has shape {tuple(t.shape)}, expected {shape}")
    if any(t.stride(-1) != 1 for t in ops):
        raise ValueError("oaca_attention kernel needs a contiguous last dimension")
    if L2 > _MAX_L2 or B * H > 65535:
        raise ValueError(f"oaca_attention kernel takes L2 <= {_MAX_L2} and B*heads <= 65535")
    if not all(loader.tma_addressable(t) for t in ops):
        raise ValueError("oaca_attention kernel's TMA route takes rows < 2^31 and strides < 2^40 bytes")
    if not scale > 0:
        raise ValueError(f"oaca_attention kernel takes a positive scale, got {scale}")


def _out_like(q_c: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B, heads, Lq, dv) result laid out (B, Lq, heads, dv) in
    memory, as the kernel writes it."""
    B, H, Lq, _ = q_c.shape
    return q_c.new_empty_strided((B, H, Lq, dv), (Lq * H * dv, dv, H * dv, 1))


def launch(q_c, ipe, k_c, k_l, v_c, v_l, *, scale: float, ipe_k=None, on: str | None = None) -> torch.Tensor:
    """One launch of the kernel on plain operands (no autograd, no
    tangent); checks them, their alignment (which reads their pointers)
    included.  ``ipe_k`` is ``ipe`` when None.  The route is :func:`route`'s,
    or with ``on`` ("core" or "mma") that one: the two side by side on the
    same operands, for the kernel table (``chip_smoke.py``,
    ``scripts/kernel_pace.py``)."""
    ipe_k = ipe if ipe_k is None else ipe_k
    _check(q_c, ipe, k_c, k_l, v_c, v_l, scale, ipe_k)
    B, H, Lq, dc = q_c.shape
    dp, L2, dv, Lk = ipe.shape[-1], k_l.shape[2], v_c.shape[-1], k_c.shape[2]
    ops = (q_c, ipe, k_c, k_l, v_c, v_l)
    loader.check_aligned("oaca_attention", *ops, ipe_k)
    out = _out_like(q_c, dv)
    args = loader.OacaArgs(
        *(t.data_ptr() for t in ops), out.data_ptr(),
        *((ctypes.c_int64 * 3)(*_strides(t)) for t in (*ops, out)),
        B, H, Lq, L2, float(scale) ** 2,
        ipe_k.data_ptr(), (ctypes.c_int64 * 3)(*_strides(ipe_k)), Lk,
    )
    lib, stream = loader.library("oaca"), torch.cuda.current_stream(q_c.device).cuda_stream
    if on is None:
        err = lib.oaca_forward(args, _DTYPE_CODES[q_c.dtype], dc, dp, dv, stream)
    elif on == "mma" and dc != 32:
        raise ValueError("oaca_attention's mma.sync loader takes head dims (32, 16 | 32 | 64, 32)")
    else:
        err = lib.oaca_forward_on(args, _DTYPE_CODES[q_c.dtype], dc, dp, dv, ("core", "mma").index(on), stream)
    loader.check(err, "oaca_forward")
    launches.n += 1
    if Lk != Lq:
        gathered_launches.n += 1
    return out


def _launch(ops: tuple, scale: float) -> torch.Tensor:
    """:func:`launch` of (q_c, ipe, k_c, k_l, v_c, v_l[, ipe_k])."""
    if len(ops) == 6:
        return launch(*ops, scale=scale)
    return launch(*ops[:6], scale=scale, ipe_k=ops[6])


@torch.library.custom_op("lidarcrafter_torch::oaca_forward", mutates_args=(), device_types="cuda")
def oaca_op(q_c: torch.Tensor, ipe: torch.Tensor, k_c: torch.Tensor, k_l: torch.Tensor,
            v_c: torch.Tensor, v_l: torch.Tensor, scale: float, ipe_k: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel as an operator that ``torch.export`` records: one
    :func:`launch` on the card, :func:`oaca_attention_plain` on the CPU,
    both laid out as the kernel writes its result."""
    return _launch((q_c, ipe, k_c, k_l, v_c, v_l) + (() if ipe_k is None else (ipe_k,)), scale)


@oaca_op.register_kernel("cpu")
def _oaca_op_cpu(q_c, ipe, k_c, k_l, v_c, v_l, scale, ipe_k=None):
    return _out_like(q_c, v_c.shape[-1]).copy_(
        oaca_attention_plain(q_c, ipe, k_c, k_l, v_c, v_l, scale=scale, ipe_k=ipe_k))


@oaca_op.register_fake
def _oaca_op_fake(q_c, ipe, k_c, k_l, v_c, v_l, scale, ipe_k=None):
    return _out_like(q_c, v_c.shape[-1])


class OacaAttention(torch.autograd.Function):
    """The kernel's forward with :func:`oaca_attention_backward` as its
    backward; ``apply(scale, q_c, ipe, k_c, k_l, v_c, v_l[, ipe_k])``."""

    @staticmethod
    def forward(ctx, scale, *ops):
        ctx.scale = scale
        ctx.save_for_backward(*ops)
        return _launch(ops, scale)

    @staticmethod
    def backward(ctx, g):
        return (None, *oaca_attention_backward(ctx.saved_tensors, g, scale=ctx.scale))


def oaca_attention(q_c, ipe, k_c, k_l, v_c, v_l, *, scale: float, ipe_k=None) -> torch.Tensor:
    """Joint softmax attention of image queries over image and layout keys.

    Args (all (B, heads, L, d), one dtype):
      q_c: per-head image content queries, L = Lq (H·W in one process).
      k_c, v_c: per-head image content keys and values, L = Lk (Lq in one
        process; every rank's tokens under the azimuth axis).
      ipe: per-head image-patch positional embedding of the queries,
        concatenated onto q_c, and onto k_c unless ``ipe_k`` is given.
      ipe_k: the image keys' positional rows (Lk), or None.
      k_l, v_l: layout strip, L2 tokens; k_l is already [k_content | pe].
      scale: the per-operand 1/√√(dc + dp) factor (applied as scale² to the
        logits).

    On the card the head dims (dc, dp, dv) must be one of ``HEAD_DIMS``:
    (32, 32, 32), (64, 64, 64), (32, 16, 32) or (32, 64, 32) (else
    ``ValueError``).
    Any strides are taken as long as the last dimension is contiguous and
    the pointers and strides are whole 16-byte pieces (else ``ValueError``).
    The kernel runs its products on the tensor cores (:func:`route`): on
    the warp-specialised TMA core, bf16 on ``wgmma`` and float32 on 3xTF32
    ``mma.sync``, except float32 at the 32-wide head dims, on the cp.async
    + mma.sync loader.  Returns (B, heads,
    Lq, dv) in the operands' dtype; on the card its memory is laid out (B, Lq, heads, dv), so that merging
    the heads back into channels is free.  With grad enabled and an operand
    that requires grad, the result carries :class:`OacaAttention`'s
    backward (on the CPU: autograd of the plain version); otherwise the
    kernel is launched directly, or, while ``torch.export`` traces the
    call, the operator :func:`oaca_op` is recorded.  An operand that
    carries a forward-mode tangent
    (``torch.func.jvp``, ``forward_ad``) raises ``NotImplementedError`` on
    the card.
    """
    ops = (q_c, ipe, k_c, k_l, v_c, v_l) + (() if ipe_k is None else (ipe_k,))
    autograd = torch.is_grad_enabled() and any(t.requires_grad for t in ops)
    tangent = loader.has_tangent(*ops)
    if not (autograd or tangent) and loader.tracing():
        return torch.ops.lidarcrafter_torch.oaca_forward(*ops[:6], float(scale), *ops[6:])
    if q_c.device.type == "cpu":
        return oaca_attention_plain(*ops[:6], scale=scale, ipe_k=ipe_k)
    if q_c.device.type != "cuda":
        raise ValueError("oaca_attention: operands must all be on one CUDA device")
    if tangent:
        raise NotImplementedError("oaca_attention has no forward-mode rule: an operand carries a tangent "
                                  "(torch.func.jvp / forward_ad), which the kernel would drop")
    if autograd:
        return OacaAttention.apply(float(scale), *ops)
    return _launch(ops, scale)
