"""GroupNorm + per-batch affine (scale-shift folded) + optional SiLU over
channels-last tensors, in one launch.

Port of the TPU kernel ``_gn_kernel`` of the JAX package
(``ops/pallas_groupnorm.py``, wrapper ``fused_group_norm``).  The CUDA kernel
is ``csrc/groupnorm.cu``: one launch, each image split into blocks of
contiguous rows (at most one block per SM), the blocks' statistics merged
after a grid sync, the rows that fit normalised from shared memory.  :func:`group_norm_plain` beside it is the
same function in plain PyTorch.  :func:`group_norm` takes the plain version
for a tensor on the CPU and launches the kernel for a tensor on the card; it
never falls back from one to the other.

Both take the raw operands of the modules: the norm's own ``weight`` and
``bias`` and the conditioning's ``scale`` and ``shift``, and fold them in
float32 as ``GN(x)·w(1+s) + b(1+s) + t``.  Unlike the TPU kernel the
statistics are direct-variance (Chan merges, never ``E[x^2] - mean^2``), so
every ``GroupNorm32`` of the port goes through it, the 26-element groups of
the attention blocks' token norms included.

On the card the kernel is differentiable through :class:`GroupNorm`: the
forward launches the kernel and keeps only its operands, the backward is
:func:`group_norm_backward`, autograd of the plain version recomputed in
float32 (the JAX package's ``_gn_ad_bwd``, the vjp of its ``_gn_ref``).  The
gradients reach ``weight``, ``bias``, ``scale`` and ``shift`` as they are
passed, strided views of the conditioning projection included.  The
forward-mode rule is :func:`group_norm_jvp`, the plain version's tangent in
float32 from recomputed statistics; an operand that carries a tangent always
goes through the Function, so no tangent reaches a bare launch.

While ``torch.export`` traces it with grad off and no tangent, the wrapper
calls the operator ``torch.ops.lidarcrafter_torch.group_norm``
(:func:`group_norm_op`), on either device: its CUDA implementation is
:func:`launch`, its CPU implementation the plain version, and its fake rule
gives the kernel's output, so that an exported sampler carries the kernel
(``serving/export.py``).  An eager call launches directly, with no
dispatcher in its host time.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import loader

launches = loader.LaunchCounter("groupnorm")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # threads a block aims for
_MAX_THREADS = 512  # the kernel's launch bound
_MIN_BLOCK_BYTES = 32 * 1024  # an image is split only into blocks of at least this
_SMEM_MAX = 232_448  # dynamic shared memory an H100 block may use


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers a (B, HW, C) tensor: each image in ``k`` blocks
    of ``threads`` threads and ``rows_per_block`` rows, of which the first
    ``stage_rows`` are kept in shared memory.  One block an image (k = 1)
    needs no grid sync."""

    k: int
    rows_per_block: int
    rows_par: int
    threads: int
    stage_rows: int
    smem: int

    @property
    def read_once(self) -> bool:
        """Every row is normalised from shared memory (one HBM read)."""
        return self.stage_rows == self.rows_per_block


@functools.lru_cache(maxsize=256)
def plan(B: int, HW: int, C: int, G: int, itemsize: int, num_sms: int = 132) -> Plan:
    """The launch ``csrc/groupnorm.cu`` runs for these shapes: an image in
    as many blocks of at least 32 KB as the SMs hold with every image split
    alike (k = 1 for the token norms); the staged rows fill the shared memory
    the scratch leaves (its size is ``scratch_bytes`` in the CUDA source)."""
    vec = 8 if itemsize == 2 and C % 8 == 0 else 4
    cpr = C // vec
    k = max(1, min(num_sms // B, HW * C * itemsize // _MIN_BLOCK_BYTES, HW))
    rows = -(-HW // k)
    k = -(-HW // rows)  # no block left empty
    rows_par = max(1, min(_THREADS // cpr, rows))
    threads = -(-(rows_par * cpr) // 32) * 32
    scratch = 16 + 4 * (threads * (2 * vec + 1) + 2 * C + 2 * G)
    stage_rows = min(rows, max(0, _SMEM_MAX - scratch) // (C * itemsize))
    return Plan(k, rows, rows_par, threads, stage_rows, stage_rows * C * itemsize + scratch)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows(t: torch.Tensor | None, C: int) -> torch.Tensor | None:
    """An affine operand as (B or 1, C) float32, for the plain version."""
    return None if t is None else t.float().reshape(-1, C)


def _fold(weight, bias, scale, shift, C: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(γ, β) = (w(1+s), b(1+s) + t) in float32, (B or 1, C) each; a None
    weight is ones, the other None operands zeros."""
    gamma, beta = _rows(weight, C), _rows(bias, C)
    gamma = torch.ones(1, C, device=device) if gamma is None else gamma
    beta = torch.zeros(1, C, device=device) if beta is None else beta
    if scale is not None:
        s1 = 1.0 + _rows(scale, C)
        gamma, beta = gamma * s1, beta * s1
    if shift is not None:
        beta = beta + _rows(shift, C)
    return gamma, beta


def _normalized(x: torch.Tensor, num_groups: int, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct two-pass statistics in float32: x̂ (B, HW, G, C/G) and
    1/σ (B, 1, G, 1)."""
    B, C = x.shape[0], x.shape[-1]
    g = x.reshape(B, -1, num_groups, C // num_groups).float()
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (g - mean) * rstd, rstd


def group_norm_plain(
    x: torch.Tensor,
    weight: torch.Tensor | None,
    bias: torch.Tensor | None,
    *,
    num_groups: int,
    eps: float,
    scale: torch.Tensor | None = None,
    shift: torch.Tensor | None = None,
    silu: bool = False,
) -> torch.Tensor:
    """Direct two-pass GroupNorm in f32, then ``y·γ + β`` with
    ``γ = w(1+s)`` and ``β = b(1+s) + t`` folded in f32, and an optional
    SiLU, cast back to ``x.dtype``.  ``x`` is (B, ..., C); ``weight`` and
    ``bias`` are (C,) or (B, C), ``scale`` and ``shift`` hold B·C values
    ((B, C), (B, 1, 1, C), ...), any of them None."""
    B, C = x.shape[0], x.shape[-1]
    y = _normalized(x, num_groups, eps)[0].reshape(B, -1, C)
    gamma, beta = _fold(weight, bias, scale, shift, C, x.device)
    y = y * gamma[:, None, :] + beta[:, None, :]
    if silu:
        y = F.silu(y)
    return y.to(x.dtype).reshape(x.shape)


def group_norm_backward(saved, g: torch.Tensor, *, num_groups: int, eps: float, silu: bool = False):
    """Gradients of :func:`group_norm` with respect to ``saved`` = (x,
    weight, bias, scale, shift), any of the last four None, for the output
    gradient ``g``: autograd of the plain version recomputed in float32, each
    gradient cast to its operand's dtype and shaped as it (None for a None
    operand)."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().float().requires_grad_() for t in saved]
        x, weight, bias, scale, shift = ins
        y = group_norm_plain(x, weight, bias, num_groups=num_groups, eps=eps,
                             scale=scale, shift=shift, silu=silu)
        grads = iter(torch.autograd.grad(y, [t for t in ins if t is not None], g.float()))
    return tuple(None if t is None else next(grads).to(t.dtype) for t in saved)


def group_norm_jvp(saved, tangents, *, num_groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """Tangent of :func:`group_norm` at ``saved`` = (x, weight, bias,
    scale, shift) along ``tangents`` (the same five; None for an absent
    operand or a zero tangent), in float32 from recomputed statistics, cast
    to x's dtype and shaped as x.  Written out: dx̂ = (dx_c − x̂·mean(x̂·dx_c))/σ
    with dx_c = dx − mean(dx) over each group, dγ = dw(1+s) + w·ds,
    dβ = db(1+s) + b·ds + dt, and dy = dx̂·γ + x̂·dγ + dβ, times SiLU's
    derivative at y.  Closed form rather than a nested ``torch.func.jvp``:
    forward-mode AD does not nest inside a ``forward_ad`` rule."""
    x, weight, bias, scale, shift = saved
    dx, dweight, dbias, dscale, dshift = tangents
    B, C = x.shape[0], x.shape[-1]
    xhat, rstd = _normalized(x, num_groups, eps)
    gamma, beta = _fold(weight, bias, scale, shift, C, x.device)
    dy = xhat.new_zeros((B, xhat.shape[1], C))
    if dx is not None:
        dg = dx.reshape(xhat.shape).float()
        dg = dg - dg.mean(dim=(1, 3), keepdim=True)
        dxhat = (dg - xhat * (xhat * dg).mean(dim=(1, 3), keepdim=True)) * rstd
        dy += dxhat.reshape(dy.shape) * gamma[:, None, :]
    zero = torch.zeros(1, C, device=x.device)
    dgamma = zero if dweight is None else _rows(dweight, C)
    dbeta = zero if dbias is None else _rows(dbias, C)
    if scale is not None:
        s1 = 1.0 + _rows(scale, C)
        dgamma, dbeta = dgamma * s1, dbeta * s1
        if dscale is not None:
            ds = _rows(dscale, C)
            dgamma = dgamma + (1.0 if weight is None else _rows(weight, C)) * ds
            dbeta = dbeta + (0.0 if bias is None else _rows(bias, C)) * ds
    if dshift is not None:
        dbeta = dbeta + _rows(dshift, C)
    dy += xhat.reshape(dy.shape) * dgamma[:, None, :] + dbeta[:, None, :]
    if silu:
        z = xhat.reshape(dy.shape) * gamma[:, None, :] + beta[:, None, :]
        sig = torch.sigmoid(z)
        dy = dy * sig * (1.0 + z * (1.0 - sig))
    return dy.to(x.dtype).reshape(x.shape)


def _operand(t: torch.Tensor | None, x: torch.Tensor, B: int, C: int, what: str) -> tuple[int, int, int]:
    """(pointer, batch stride, dtype code) of an affine operand for the
    kernel, read in place: (C,), (1, C), (B, C) or (B, 1, ..., 1, C) with
    unit channel stride (a ``chunk`` half of a projection passes)."""
    if t is None:
        return 0, 0, 0
    shape, stride = t.shape, t.stride()
    rows = shape[0] if len(shape) > 1 else 1
    code = _DTYPE_CODES.get(t.dtype)
    if (shape[-1] != C or rows not in (1, B) or t.numel() != rows * C or (C > 1 and stride[-1] != 1)
            or code is None or t.device != x.device):
        raise ValueError(f"group_norm {what}: expected (C,) or (B, C) float32/bfloat16 values with unit "
                         f"channel stride on {x.device}, got shape {tuple(shape)}, strides {stride}, "
                         f"{t.dtype} on {t.device} for B={B}, C={C}")
    return t.data_ptr(), stride[0] if rows > 1 else 0, code


def _args(x, y, weight, bias, scale, shift, work, num_groups, eps, silu, p: Plan) -> loader.GnArgs:
    B, C = x.shape[0], x.shape[-1]
    ops = [_operand(t, x, B, C, what) for t, what in
           ((weight, "weight"), (bias, "bias"), (scale, "scale"), (shift, "shift"))]
    (w, w_bs, w_dt), (b, b_bs, b_dt), (s, s_bs, s_dt), (t, t_bs, t_dt) = ops
    return loader.GnArgs(
        x.data_ptr(), y.data_ptr(), w, b, s, t, w_bs, b_bs, s_bs, t_bs, w_dt, b_dt, s_dt, t_dt,
        0 if work is None else work.data_ptr(), _DTYPE_CODES[x.dtype], B, x.numel() // (B * C), C, num_groups,
        p.k, p.rows_par, p.stage_rows, int(silu), float(eps),
    )


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor | None,
    bias: torch.Tensor | None,
    *,
    num_groups: int,
    eps: float,
    scale: torch.Tensor | None = None,
    shift: torch.Tensor | None = None,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+per-batch affine)(+SiLU) of a channels-last tensor.

    Args:
      x: (B, ..., C), float32 or bfloat16.
      weight, bias: the norm's affine, (C,) or (B, C), float32 or bfloat16,
        or None (ones, zeros).
      scale, shift: the ADM scale-shift conditioning, B·C values each with
        unit channel stride (the ``chunk`` halves of a projection pass as
        they are), or None; the output is ``GN(x)·w(1+s) + b(1+s) + t``.
      num_groups, eps: the GroupNorm's groups and epsilon.
      silu: apply SiLU before the single write.

    Returns a tensor of ``x``'s shape and dtype.  An operand that carries a
    forward-mode tangent (``torch.func.jvp``, ``forward_ad``), or, with grad
    enabled, one that requires grad, sends the call through
    :class:`GroupNorm` (on the CPU: the plain version); otherwise the kernel
    is launched directly, or, while ``torch.export`` traces the call, the
    operator :func:`group_norm_op` is recorded.
    """
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    ops = (x, weight, bias, scale, shift)
    autograd = loader.has_tangent(*ops) or (
        torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ops))
    if not autograd and loader.tracing():
        return torch.ops.lidarcrafter_torch.group_norm(x, weight, bias, scale, shift, num_groups, float(eps),
                                                       bool(silu))
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups=num_groups, eps=eps,
                                scale=scale, shift=shift, silu=silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if autograd:
        return GroupNorm.apply(num_groups, float(eps), bool(silu), x, weight, bias, scale, shift)
    return launch(x, weight, bias, scale, shift, num_groups=num_groups, eps=eps, silu=silu)


def launch(x, weight, bias, scale, shift, *, num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """One launch of the kernel on plain operands (no autograd, no tangent)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm kernel is built for float32/bfloat16, got {x.dtype}")
    B, C = x.shape[0], x.shape[-1]
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernel needs a 16-byte aligned x")
    p = plan(B, x.numel() // (B * C), C, num_groups, x.element_size(), _num_sms(x.device.index))
    if C % 4 or p.threads > _MAX_THREADS or p.smem > _SMEM_MAX:
        raise ValueError(f"group_norm kernel needs C % 4 == 0 and C <= {_MAX_THREADS * 4}, got {C}")
    y = torch.empty_like(x)
    work = torch.empty(B * p.k * 3 * num_groups, device=x.device) if p.k > 1 else None
    args = _args(x, y, weight, bias, scale, shift, work, num_groups, eps, silu, p)
    err = loader.library("groupnorm").gn_forward(args, torch.cuda.current_stream(x.device).cuda_stream)
    loader.check(err, "gn_forward")
    launches.n += 1
    return y


@torch.library.custom_op("lidarcrafter_torch::group_norm", mutates_args=(), device_types="cuda")
def group_norm_op(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
                  scale: torch.Tensor | None, shift: torch.Tensor | None,
                  num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    """The kernel as an operator that ``torch.export`` records: one
    :func:`launch` on the card, :func:`group_norm_plain` on the CPU; the
    result is a new contiguous tensor of ``x``'s shape and dtype."""
    return launch(x, weight, bias, scale, shift, num_groups=num_groups, eps=eps, silu=silu)


@group_norm_op.register_kernel("cpu")
def _group_norm_op_cpu(x, weight, bias, scale, shift, num_groups, eps, silu):
    return group_norm_plain(x, weight, bias, num_groups=num_groups, eps=eps, scale=scale, shift=shift, silu=silu)


@group_norm_op.register_fake
def _group_norm_op_fake(x, weight, bias, scale, shift, num_groups, eps, silu):
    return x.new_empty(x.shape)


class GroupNorm(torch.autograd.Function):
    """The kernel's forward with :func:`group_norm_backward` as its backward
    and :func:`group_norm_jvp` as its forward-mode rule; ``apply(num_groups,
    eps, silu, x, weight, bias, scale, shift)``.  The forward takes no ctx,
    so ``torch.func`` transforms hand it the plain operands."""

    @staticmethod
    def forward(num_groups, eps, silu, *ops):
        return launch(*ops, num_groups=num_groups, eps=eps, silu=silu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        num_groups, eps, silu, *ops = inputs
        ctx.norm = dict(num_groups=num_groups, eps=eps, silu=silu)
        ctx.save_for_backward(*ops)
        ctx.save_for_forward(*ops)

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, *group_norm_backward(ctx.saved_tensors, g, **ctx.norm))

    @staticmethod
    def jvp(ctx, _num_groups, _eps, _silu, *tangents):
        return group_norm_jvp(ctx.saved_tensors, tangents, **ctx.norm)
