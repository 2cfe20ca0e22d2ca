"""Train state: the step, the online modules, their EMA copies and the
optimizer state.

The port's counterpart of the JAX package's ``training/state.py``.  The
online modules hold the parameters (the engine that trains them holds the
same modules), so the state is changed in place by the train step rather
than replaced.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from .optim import AdamW


def named_module_params(modules: dict[str, nn.Module]) -> list[tuple[str, torch.Tensor]]:
    """The trained tensors of ``modules`` as ``('key.name', tensor)``, in
    key order: each module's parameters, then its buffers that require grad
    (the layout branch's running statistics, which the JAX package trains
    with the parameters: ``training/loop.py::train_running_statistics_``).
    The optimizer state and the EMA follow this order."""
    out = []
    for key in sorted(modules):
        m = modules[key]
        trained = [*m.named_parameters(), *((n, b) for n, b in m.named_buffers() if b.requires_grad)]
        out += [(f"{key}.{n}", t) for n, t in trained]
    return out


def module_params(modules: dict[str, nn.Module]) -> list[torch.Tensor]:
    """The tensors of :func:`named_module_params`."""
    return [t for _, t in named_module_params(modules)]


@dataclasses.dataclass
class TrainState:
    step: int
    models: dict[str, nn.Module]  # online: {'model'} or {'model', 'cond'}
    ema: dict[str, nn.Module]  # EMA copies of ``models``, no grad
    opt_state: dict

    @classmethod
    def create(cls, models: dict[str, nn.Module], optimizer: AdamW) -> "TrainState":
        ema = {}
        for k, m in models.items():
            ema[k] = copy.deepcopy(m).requires_grad_(False)
            for b in ema[k].buffers():
                b.requires_grad_(False)
        return cls(step=0, models=models, ema=ema, opt_state=optimizer.init(module_params(models)))

    def params(self) -> list[torch.Tensor]:
        return module_params(self.models)

    def ema_params(self) -> list[torch.Tensor]:
        """The EMA copies of :meth:`params`, matched by name (the EMA's
        tensors do not require grad, so they are looked up by the online
        modules' names, not selected as trained)."""
        ema = {f"{k}.{n}": t for k, m in self.ema.items()
               for n, t in (*m.named_parameters(), *m.named_buffers())}
        return [ema[n] for n, _ in named_module_params(self.models)]
