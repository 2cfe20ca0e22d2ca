"""Optimizers and LR schedules of the trainers.

Port of the JAX package's ``training/optim.py``: ``clip_by_global_norm``
→ AdamW on the cosine-warmup schedule, with ``optax.MultiSteps`` gradient
accumulation, written as optax computes them, over a list of tensors with
``torch._foreach_*`` ops (a handful of launches per update, whatever the
number of tensors).  The update count, the bias corrections and the LR are
host numbers, so an update never reads the device back.

The auxiliary trainers' pieces sit beside them: optax's cosine one-cycle
and cosine-decay schedules (GLENet, PointMLP) and :class:`SGD`, optax's
``add_decayed_weights`` → ``sgd`` with momentum (PointMLP, RangeNet).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch


def cosine_warmup_schedule(
    base_lr: float,
    num_warmup_steps: int,
    num_training_steps: int,
    num_cycles: float = 0.5,
) -> Callable[[int], float]:
    """lr(count): linear warmup from 0, then cosine decay; lr(0) = 0 under
    warmup, as optax evaluates the schedule at the update count before it
    is incremented."""

    def schedule(count: int) -> float:
        if count < num_warmup_steps:
            return base_lr * count / max(1, num_warmup_steps)
        progress = (count - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def cosine_onecycle_schedule(
    transition_steps: int,
    peak_value: float,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule``: from ``peak / div_factor`` up to
    ``peak`` over the first ``int(pct_start · T)`` counts, then down to
    ``peak / (div_factor · final_div_factor)`` at ``T``, each leg a half
    cosine; constant after ``T``.  Where the first leg is empty
    (``int(pct_start · T) = 0``) optax returns NaN at every count; this
    starts on the second leg."""
    if transition_steps <= 0:
        raise ValueError("a one-cycle schedule needs a positive transition_steps")
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    init = peak_value / div_factor
    values = (init, init * div_factor, init * div_factor / (div_factor * final_div_factor))

    def schedule(count: int) -> float:
        if count >= bounds[2]:
            return values[2]
        i = 0 if count < bounds[1] else 1
        pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
        return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``init · ((1 − alpha) · ½(1 +
    cos(π · min(count, T) / T)) + alpha)``."""
    if decay_steps <= 0:
        raise ValueError("a cosine decay needs a positive decay_steps")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.chain(add_decayed_weights(weight_decay), sgd(schedule,
    momentum))``: ``trace = g + weight_decay·p + momentum·trace``, then
    ``p −= lr(count) · trace``, the LR at the update count before this
    update.  The state (:meth:`init`): ``count`` and ``trace``."""

    schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

    def lr(self, count: int) -> float:
        return self.schedule(count)

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict) -> None:
        """One update: ``params`` and ``state`` change in place; ``grads``
        may be overwritten."""
        if self.weight_decay:
            torch._foreach_add_(grads, params, alpha=self.weight_decay)
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, trace, alpha=-self.lr(state["count"]))
        state["count"] += 1


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps, weight_decay=weight_decay))``, wrapped in ``optax.MultiSteps`` when
    ``accum_steps`` > 1: every :meth:`update_` call is a micro-step, the
    gradients average over ``accum_steps`` calls, the parameters move on
    every ``accum_steps``-th call, and the schedule advances per
    micro-step (the update count times ``accum_steps``).

    The state (:meth:`init`) is a dict: ``count`` (updates made),
    ``mu`` / ``nu`` (the moments), and with accumulation ``mini_step`` and
    ``acc`` (the running mean of the micro-steps' gradients).
    """

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    accum_steps: int = 1

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.accum_steps > 1:
            state.update(mini_step=0, acc=zeros())
        return state

    def lr(self, count: int) -> float:
        """The LR of update ``count`` (from 0)."""
        return self.schedule(count * self.accum_steps)

    @torch.no_grad()
    def update_(self, params: list[torch.Tensor], grads: list[torch.Tensor], state: dict) -> None:
        """One micro-step: ``params`` and ``state`` change in place;
        ``grads`` may be overwritten."""
        if self.accum_steps > 1:
            n, acc = state["mini_step"], state["acc"]
            # optax.MultiSteps: acc = (g + n·acc) / (n + 1)
            torch._foreach_mul_(acc, float(n))
            torch._foreach_add_(acc, grads)
            torch._foreach_div_(acc, float(n + 1))
            if n + 1 < self.accum_steps:
                state["mini_step"] = n + 1
                return
            grads, state["acc"] = acc, [torch.zeros_like(a) for a in acc]
            state["mini_step"] = 0
        # clip_by_global_norm: g · max_norm / max(‖g‖, max_norm), on the device
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        # scale_by_adam
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        count = state["count"] + 1
        denom = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, 1.0 - self.b1**count)
        torch._foreach_div_(update, denom)
        # add_decayed_weights, then scale_by_learning_rate at the count before
        # this update
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-self.lr(state["count"]))
        state["count"] = count


def make_optimizer(
    lr: float = 1e-4,
    warmup_steps: int = 10_000,
    num_steps: int = 300_000,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float = 1.0,
    grad_accum_steps: int = 1,
) -> AdamW:
    """AdamW + clip (+ accumulation) on the cosine-warmup schedule, as the
    JAX package's ``make_optimizer`` builds it."""
    return AdamW(
        cosine_warmup_schedule(lr, warmup_steps, num_steps), b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, grad_clip=grad_clip, accum_steps=grad_accum_steps,
    )
