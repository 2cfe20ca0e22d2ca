"""Exponential moving average of the parameters, with ``ema_pytorch.EMA``'s
schedule as the reference trainer uses it.

Port of the JAX package's ``training/ema.py``:

- one call per optimizer step; the EMA moves only every ``update_every``
  calls;
- until ``update_after_step`` the EMA is a copy of the online weights;
- afterwards the decay ramps as ``1 - (1 + epoch/inv_gamma)^(-power)``,
  clamped to ``[0, beta]``.

The decay is a host number (the step is one), so the update is one or two
``torch._foreach_*`` ops over all tensors, or nothing on a step that does
not move the EMA.
"""

from __future__ import annotations

import torch


def ema_decay_schedule(
    step: int,
    beta: float = 0.995,
    update_after_step: int = 100,
    inv_gamma: float = 1.0,
    power: float = 2.0 / 3.0,
) -> float:
    """Current decay given the number of ``update()`` calls so far."""
    epoch = max(step - update_after_step - 1, 0)
    if epoch <= 0:
        return 0.0
    value = 1.0 - (1.0 + epoch / inv_gamma) ** (-power)
    return min(max(value, 0.0), beta)


@torch.no_grad()
def ema_update_(
    ema_params: list[torch.Tensor],
    online_params: list[torch.Tensor],
    step: int,
    beta: float = 0.995,
    update_every: int = 10,
    update_after_step: int = 100,
    inv_gamma: float = 1.0,
    power: float = 2.0 / 3.0,
) -> None:
    """One (conditional) EMA step in place: ``e·decay + o·(1 - decay)`` on
    every ``update_every``-th step (``step`` counts optimizer steps from
    0), a copy while the decay is 0."""
    if step % update_every:
        return
    decay = ema_decay_schedule(step, beta, update_after_step, inv_gamma, power)
    if decay == 0.0:
        torch._foreach_copy_(ema_params, online_params)
        return
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, online_params, alpha=1.0 - decay)
