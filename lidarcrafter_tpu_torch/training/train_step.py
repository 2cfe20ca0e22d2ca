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
on bf16 casts of the float32 master parameters and of their inputs, and
their outputs are cast back to float32; the casts carry the gradients back
to the masters, and schedules, q-sampling and the loss stay float32.
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
    """``module``'s forward on bf16 casts of its parameters and of the
    floating inputs, with the floating outputs cast to float32."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args):
        params = {n: p.to(torch.bfloat16) for n, p in self.module.named_parameters()}
        out = torch.func.functional_call(self.module, params, cast_tree(args, torch.bfloat16))
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


def loss_and_grads(engine, params: list[torch.Tensor], batch, **loss_kwargs):
    """``engine.loss(batch, **loss_kwargs)`` and its gradients with respect
    to ``params`` (zeros for a parameter the loss does not reach)."""
    loss = engine.loss(batch, **loss_kwargs)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_train_step(
    engine,
    optimizer: AdamW,
    ema_beta: float = 0.995,
    ema_update_every: int = 10,
    ema_update_after_step: int = 100,
    amp: bool = False,
) -> Callable[..., tuple[TrainState, torch.Tensor]]:
    """Build ``train_step(state, batch, seed, t=None, noise=None)``.

    ``batch`` is the engine's input: x_0 (B, H, W, C) normalized to [-1, 1],
    or the conditional engine's input dict with ``x_0``.  ``state.models``
    must be the modules ``engine`` runs.  ``t`` and ``noise`` replace the
    step's draws when given (parity tests inject the JAX key chain's).
    The state is updated in place and returned with the loss tensor.
    """
    if amp:
        engine = amp_engine(engine)

    def train_step(state: TrainState, batch, seed: int, t=None, noise=None):
        x_0 = batch["x_0"] if isinstance(batch, dict) else batch
        generator = step_generator(seed, state.step, x_0.device)
        params = state.params()
        loss, grads = loss_and_grads(engine, params, batch, generator=generator, t=t, noise=noise)
        optimizer.update_(params, grads, state.opt_state)
        ema_update_(state.ema_params(), params, state.step, beta=ema_beta,
                    update_every=ema_update_every, update_after_step=ema_update_after_step)
        state.step += 1
        return state, loss

    return train_step
