"""The training step: loss, gradients, the optimizer update and the EMA.

Port of the JAX package's ``training/train_step.py``.  ``make_train_step``
builds ``train_step(state, batch, seed) -> (state, loss)``: the engine's
loss under autograd, the gradients of every online parameter, the AdamW
update (``optim.py``) and the EMA (``ema.py``), all queued on the device
with no host read; the loss comes back as a tensor.  Each step's randomness
(t, then the noise) comes from a generator seeded by (seed, step), as the
JAX step folds the step into its key, so a resumed run repeats an unbroken
one.

``amp=True`` is the JAX package's bf16 AMP (``amp_engine`` / ``_amp_wrap``):
the model and encoder forwards run through ``torch.func.functional_call``
on bf16 casts of the float32 master parameters (and running statistics,
which the JAX package keeps in the same tree) and of their inputs, and
their outputs are cast back to float32; the casts carry the gradients back
to the masters, and a ``torch.func.jvp`` tangent through them (the MeanFlow
loss), while schedules, q-sampling and the loss stay float32.
``torch.autocast`` would keep GroupNorm and softmax in float32 and so send
mixed dtypes to the kernels; here every operand of a kernel is bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..precision import cast_tree
from .ema import ema_update_
from .optim import AdamW
from .state import TrainState


class Bf16Forward(nn.Module):
    """``module``'s forward on bf16 casts of its parameters, of its floating
    persistent buffers (the running statistics of the layout branch; none
    in the frame stacks, whose forward casts only the parameters) and of
    the floating inputs, with the floating outputs cast to float32."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module
        persistent = set(module.state_dict(keep_vars=True))
        self.cast_buffers = {n for n, b in module.named_buffers() if n in persistent and b.is_floating_point()}

    def forward(self, *args, **kwargs):
        state = {n: p.to(torch.bfloat16) for n, p in self.module.named_parameters()}
        if self.cast_buffers:
            state.update((n, b.to(torch.bfloat16)) for n, b in self.module.named_buffers() if n in self.cast_buffers)
        out = torch.func.functional_call(self.module, state, cast_tree(args, torch.bfloat16),
                                         cast_tree(kwargs, torch.bfloat16))
        return cast_tree(out, torch.float32)


def amp_engine(engine):
    """A copy of ``engine`` whose model (and condition encoder) forwards run
    under bf16 AMP."""
    updates = {"model": Bf16Forward(engine.model)}
    if hasattr(engine, "cond_model"):
        updates["cond_model"] = Bf16Forward(engine.cond_model)
    return dataclasses.replace(engine, **updates)


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of step ``step`` of a run seeded ``seed``."""
    state = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def loss_and_grads(engine, params: list[torch.Tensor], batch, loss_has_aux: bool = False, **loss_kwargs):
    """``engine.loss(batch, **loss_kwargs)`` (its first element with
    ``loss_has_aux``) and its gradients with respect to ``params`` (zeros
    for a parameter the loss does not reach)."""
    loss = engine.loss(batch, **loss_kwargs)
    if loss_has_aux:
        loss = loss[0]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_train_step(
    engine,
    optimizer: AdamW,
    ema_beta: float = 0.995,
    ema_update_every: int = 10,
    ema_update_after_step: int = 100,
    amp: bool = False,
    loss_kwargs: dict | None = None,
    loss_has_aux: bool = False,
) -> Callable[..., tuple[TrainState, torch.Tensor]]:
    """Build ``train_step(state, batch, seed, **draws)``.

    ``batch`` is the engine's input: x_0 (B, H, W, C) normalized to [-1, 1],
    or the conditional engine's input dict (with ``x_0``, or the layout
    engine's ``boxes``).  ``state.models`` must be the modules ``engine``
    runs.  ``loss_kwargs`` go to every ``engine.loss`` call (the layout
    engine's ``num_scenes``); ``loss_has_aux`` takes the loss from a
    ``(loss, aux)`` return (MeanFlow's ``(loss, mse)``).  ``draws`` (``t``,
    ``noise``, the layout engine's ``t_scene``, MeanFlow's ``r``) replace
    the step's draws when given (parity tests inject the JAX key chain's).
    The state is updated in place and returned with the loss tensor.
    """
    if amp:
        engine = amp_engine(engine)
    loss_kwargs = loss_kwargs or {}

    def train_step(state: TrainState, batch, seed: int, **draws):
        params = state.params()
        generator = step_generator(seed, state.step, params[0].device)
        loss, grads = loss_and_grads(engine, params, batch, loss_has_aux, generator=generator, **draws,
                                     **loss_kwargs)
        optimizer.update_(params, grads, state.opt_state)
        ema_update_(state.ema_params(), params, state.step, beta=ema_beta,
                    update_every=ema_update_every, update_after_step=ema_update_after_step)
        state.step += 1
        return state, loss

    return train_step
