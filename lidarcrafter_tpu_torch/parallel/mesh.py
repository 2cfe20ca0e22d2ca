"""The (dp, sp) process mesh: the port's counterpart of the JAX package's
``parallel/mesh.py``.

Axes, as in the JAX package:

- ``dp`` — data parallel: the batch's rows split over the ranks;
- ``sp`` — azimuth parallel: the periodic W axis of the range images split
  over the ranks of one ``dp`` index.

Rank r of a ``world``-process group (``torch.distributed``) sits at
``(r // sp, r % sp)``, as the JAX package's ``reshape(dp, sp)`` of its
device list places device r.  The JAX package leaves the split over
``sp`` to its partitioner, which lowers the ring pad and the conv halos to
neighbour ``collective-permute``s.  The port has no partitioner, so the
layers exchange what they need through the mesh themselves, inside
:meth:`Mesh.active` (:func:`azimuth` names the mesh there):

- :meth:`Mesh.halo`: the neighbours' edge columns of an NHWC tensor,
  periodic over the ring of ``sp`` ranks (``models/ops.py``: the ring
  convs and the FIR resampling; HDiT's neighbourhood attention), or with
  zeros past the global ends (``wrap=False``: the zero-padded convs of v0's
  ``LayoutUnet``);
- :meth:`Mesh.gather_w`: a tensor's columns from every ``sp`` rank, in the
  global column order (the attention blocks' keys and values: OACA,
  ``SelfAttention2d``, GLIDE's block, the ``SpatialTransformer``'s
  self-attention, HDiT's global level);
- :meth:`Mesh.gather_sp`: one tensor from every ``sp`` rank, stacked in rank
  order (the GroupNorm partials, ``kernels/groupnorm.py``);
- :meth:`Mesh.sum_sp`: a sum over the ``sp`` ranks (the loss's per-sample
  sums, ``diffusion/continuous.py``).

Each is differentiable: the backward of a gather sums the gradients of
every rank's copy and keeps this rank's part, that of the sum sums too
(the adjoints of the collectives), so that the gradients averaged over the
whole world are those of one process.  Each carries a forward-mode tangent
too (the MeanFlow loss's jvp): the tangent of a gather is the gather of the
tangents, that of a sum the sum of the tangents.  Under ``torch.func.jvp``
the exchange's ``jvp`` rule makes a second exchange for the tangent (the
transform hands ``forward`` and ``jvp`` their operands apart); a
``forward_ad`` dual is unpacked at the call and its primal and tangent
travel stacked in one exchange.  :attr:`Mesh.exchanges` counts the
collectives a rank has made.  With ``sp`` = 1 no mesh is active and the
layers take their own wrap and statistics: nothing new runs.

Transport (chosen from the group's backend, never by catching a failure):
NCCL gathers with ``all_gather_into_tensor``; gloo on CPU tensors with
``all_gather``; gloo on CUDA tensors, which it takes only in ``broadcast``
and ``all_reduce``, with an ``all_reduce`` (sum) of a zero-filled buffer in
which each rank writes its own slot, exact for finite values (bfloat16 rides
as float32, exactly).  The sums are ``all_reduce`` on every backend.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.autograd import forward_ad

from ..draws import Columns, Rows

_ACTIVE: contextvars.ContextVar["Mesh | None"] = contextvars.ContextVar("azimuth_mesh", default=None)


def azimuth() -> "Mesh | None":
    """The mesh whose ``sp`` axis splits the azimuth of the tensors the
    layers see: inside :meth:`Mesh.active` of a mesh with ``sp`` > 1; None
    otherwise (one process, or ``sp`` = 1)."""
    return _ACTIVE.get()


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a (dp, sp) mesh of ``world`` ranks, with the
    ``sp`` and ``dp`` subgroups it belongs to (None where the group is
    the whole world, or where the mesh only describes a layout: no
    process group)."""

    rank: int
    world: int
    dp: int
    sp: int
    sp_group: Any = None
    dp_group: Any = None
    joined: bool = False
    exchanges: int = 0  # collectives this rank has made through the mesh

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    @contextlib.contextmanager
    def active(self):
        """The layers run sharded over ``sp`` inside (no change with
        ``sp`` = 1)."""
        if self.sp == 1:
            yield self
            return
        if not self.joined:
            raise RuntimeError("a mesh with sp > 1 needs the process group it was made in")
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    # ------------------------------------------------------------ transport

    @staticmethod
    def _wide(t: torch.Tensor, group) -> torch.Tensor:
        """``t`` as gloo carries it: bfloat16 as float32 (exact both ways)."""
        return t.float() if t.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo" else t

    def _gather(self, t: torch.Tensor, group, n: int, index: int) -> torch.Tensor:
        """``t`` of each of the ``n`` ranks of ``group`` (this one at
        ``index``), stacked in rank order; not differentiable."""
        t = t.detach().contiguous()
        self.exchanges += 1
        if dist.get_backend(group) == "nccl":
            out = t.new_empty((n * t.numel(),))
            dist.all_gather_into_tensor(out, t.reshape(-1), group=group)
            return out.view(n, *t.shape)
        wide = self._wide(t, group)
        if t.is_cuda:  # gloo takes CUDA tensors only in broadcast and all_reduce
            out = wide.new_zeros((n, *t.shape))
            out[index] = wide
            dist.all_reduce(out, group=group)
        else:
            parts = [torch.empty_like(wide) for _ in range(n)]
            dist.all_gather(parts, wide, group=group)
            out = torch.stack(parts)
        return out.to(t.dtype)

    def _sum(self, t: torch.Tensor, group) -> torch.Tensor:
        """The sum of ``t`` over ``group``; not differentiable."""
        out = self._wide(t.detach(), group).clone(memory_format=torch.contiguous_format)
        self.exchanges += 1
        dist.all_reduce(out, group=group)
        return out.to(t.dtype)

    # -------------------------------------------------------- the layers' ops

    def gather_sp(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every ``sp`` rank, stacked in rank order: (sp, *t.shape);
        differentiable, and with a forward-mode tangent."""
        primal, tangent = _unpack(t)
        if tangent is None:
            return _GatherSp.apply(t, self)
        both = _GatherSp.apply(torch.stack([primal, tangent]), self)
        return forward_ad.make_dual(both[:, 0], both[:, 1])

    def sum_sp(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ``sp`` ranks; differentiable, and with
        a forward-mode tangent."""
        primal, tangent = _unpack(t)
        if tangent is None:
            return _SumSp.apply(t, self)
        both = _SumSp.apply(torch.stack([primal, tangent]), self)
        return forward_ad.make_dual(both[0], both[1])

    def gather_w(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The whole of ``x``'s axis ``dim`` (this rank's columns; W of NHWC
        by default) from every ``sp`` rank, in the global order."""
        return torch.cat(self.gather_sp(x).unbind(0), dim=dim)

    def halo(self, x: torch.Tensor, left: int, right: int, wrap: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """The ``left`` columns before ``x``'s first (the last of the rank on
        the left) and the ``right`` columns after its last (the first of the
        rank on the right) of an NHWC shard (axis 2; any trailing axes).
        Past the global ends the ring wraps (rank 0's left halo is the last
        rank's columns, the last rank's right halo rank 0's), or with
        ``wrap=False`` the halo there is zeros, as a zero-padded axis has.
        Differentiable: each halo's gradient is added to its owner's
        columns (a zero halo sends none)."""
        W = x.shape[2]
        if left > W or right > W:
            raise ValueError(f"a halo of ({left}, {right}) columns reaches past the neighbours' {W} columns")
        edges = self.gather_sp(torch.cat([x[:, :, :right], x[:, :, W - left:]], dim=2))
        i = self.sp_index
        halo_left, halo_right = edges[(i - 1) % self.sp][:, :, right:], edges[(i + 1) % self.sp][:, :, :right]
        if not wrap and i == 0:
            halo_left = torch.zeros_like(halo_left)
        if not wrap and i == self.sp - 1:
            halo_right = torch.zeros_like(halo_right)
        return halo_left, halo_right

    def sp_only(self) -> "Mesh":
        """This rank's ``sp`` group as a mesh of its own (dp = 1)."""
        return dataclasses.replace(self, rank=self.sp_index, world=self.sp, dp=1, dp_group=None)

    def columns(self, width: int) -> slice:
        """This rank's columns of an axis of ``width`` (the whole) columns."""
        n = width // self.sp
        return slice(self.sp_index * n, (self.sp_index + 1) * n)

    # ------------------------------------------------------- whole tensors

    def cut_batch(self, batch: dict, azimuth_keys, rows: bool = True) -> dict:
        """This rank's share of a dict of global tensors: the columns (axis
        2) of the values under ``azimuth_keys``, and with ``rows`` the rows
        of every tensor over ``dp``; other values pass as they are."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor) and v.ndim:
                sp_axis = 2 if k in azimuth_keys else None
                if rows:
                    v = batch_sharding(self, v.ndim, sp_axis).cut(v)
                elif sp_axis is not None and self.sp > 1:
                    v = v[:, :, self.columns(v.shape[2])]
            out[k] = v
        return out

    def gather(self, t: torch.Tensor, sp_axis: int | None = None) -> torch.Tensor:
        """The global tensor of this rank's shard ``t`` (rows over ``dp``,
        axis ``sp_axis`` over ``sp``), on every rank; not differentiable."""
        if sp_axis is not None and self.sp > 1:
            t = torch.cat(self._gather(t, self.sp_group, self.sp, self.sp_index).unbind(0), dim=sp_axis)
        if self.dp > 1:
            t = torch.cat(self._gather(t, self.dp_group, self.dp, self.dp_index).unbind(0), dim=0)
        return t


def _unpack(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(primal, tangent) of a ``forward_ad`` dual; ``(t, None)`` for a plain
    tensor and for one that a ``torch.func`` transform wraps (its tangent
    reaches the exchange's ``jvp`` rule)."""
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        return t, None
    return forward_ad.unpack_dual(t)


class _GatherSp(torch.autograd.Function):
    """The gather over the ``sp`` ranks; ``forward`` without ctx, so that
    ``torch.func`` transforms hand it (and ``jvp``) plain tensors, which a
    collective can send."""

    @staticmethod
    def forward(t, mesh):
        return mesh._gather(t, mesh.sp_group, mesh.sp, mesh.sp_index)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return mesh._sum(g, mesh.sp_group)[mesh.sp_index], None

    @staticmethod
    def jvp(ctx, dt, _):
        mesh = ctx.mesh
        return mesh._gather(dt, mesh.sp_group, mesh.sp, mesh.sp_index)


class _SumSp(torch.autograd.Function):
    """The sum over the ``sp`` ranks, in the setup-context form of
    :class:`_GatherSp`."""

    @staticmethod
    def forward(t, mesh):
        return mesh._sum(t, mesh.sp_group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._sum(g, ctx.mesh.sp_group), None

    @staticmethod
    def jvp(ctx, dt, _):
        return ctx.mesh._sum(dt, ctx.mesh.sp_group)


def make_mesh(world: int | None = None, dp: int | None = None, sp: int = 1, rank: int | None = None) -> Mesh:
    """The (dp, sp) mesh over the ``torch.distributed`` group (one process
    without one); ``dp`` defaults to ``world // sp``.  Joined to a group of
    ``world`` ranks, it builds the ``sp`` subgroups (the ranks of one dp
    index) and, with ``sp`` > 1, the ``dp`` subgroups (the ranks of one sp
    index): every rank must make the same meshes in the same order.  With
    ``rank`` given and no group of ``world`` ranks it is a layout only
    (:func:`batch_sharding` cuts, nothing communicates)."""
    joined = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if joined else 1
    joined = joined and dist.get_world_size() == world
    if rank is None:
        rank = dist.get_rank() if joined else 0
    if dp is None:
        if world % sp:
            raise ValueError(f"sp={sp} does not divide the {world} ranks")
        dp = world // sp
    if dp * sp != world or not 0 <= rank < world:
        raise ValueError(f"a ({dp}, {sp}) mesh does not hold rank {rank} of {world}")
    mesh = Mesh(rank, world, dp, sp, joined=joined)
    if joined and sp > 1:
        for i in range(dp):
            group = dist.new_group([i * sp + j for j in range(sp)])
            if i == mesh.dp_index:
                mesh.sp_group = group
        for j in range(sp):
            group = dist.new_group([i * sp + j for i in range(dp)])
            if j == mesh.sp_index:
                mesh.dp_group = group
    return mesh


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Rows (dim 0) over ``dp`` and, with ``sp_axis``, that axis over
    ``sp``: the JAX package's ``batch_sharding`` for this rank."""

    mesh: Mesh
    ndim: int | None  # None: replicated
    sp_axis: int | None = None

    def slices(self, shape: tuple) -> tuple[slice, ...]:
        """This rank's slices of a global tensor of ``shape``."""
        if self.ndim is None:
            return (slice(None),) * len(shape)
        if len(shape) != self.ndim:
            raise ValueError(f"a {self.ndim}-d sharding of a {len(shape)}-d shape")
        out = [slice(None)] * self.ndim
        m = self.mesh
        for axis, n, i in ((0, m.dp, m.dp_index), (self.sp_axis, m.sp, m.sp_index)):
            if axis is None or n == 1:
                continue
            if shape[axis] % n:
                raise ValueError(f"axis {axis} of {tuple(shape)} does not split into {n}")
            size = shape[axis] // n
            out[axis] = slice(i * size, (i + 1) * size)
        return tuple(out)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the global tensor ``t``."""
        return t[self.slices(tuple(t.shape))]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor of the shards ``t``, on every rank."""
        return t if self.ndim is None else self.mesh.gather(t, self.sp_axis)

    def rows(self, total: int, width: int | None = None) -> Rows:
        """This rank's window of a draw of ``total`` rows (and, with
        ``width``, of the sharded axis's ``width`` columns)."""
        m = self.mesh
        n = total // m.dp
        cols = None
        if self.sp_axis is not None and m.sp > 1 and width is not None:
            c = m.columns(width)
            cols = Columns(c.start, c.stop - c.start, width, self.sp_axis)
        return Rows(m.dp_index * n, n, total, cols=cols)


def batch_sharding(mesh: Mesh, ndim: int, sp_axis: int | None = None) -> Sharding:
    """Dim 0 over ``dp`` and, optionally, ``sp_axis`` over ``sp``; for NHWC
    range images ``sp_axis=2`` splits the azimuth (W)."""
    return Sharding(mesh, ndim, sp_axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Every rank holds the whole tensor."""
    return Sharding(mesh, None)
