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


def module_params(modules: dict[str, nn.Module]) -> list[torch.Tensor]:
    """The parameters of ``modules``, in key order, then ``parameters()``
    order: the order the optimizer state and the EMA follow."""
    return [p for name in sorted(modules) for p in modules[name].parameters()]


@dataclasses.dataclass
class TrainState:
    step: int
    models: dict[str, nn.Module]  # online: {'model'} or {'model', 'cond'}
    ema: dict[str, nn.Module]  # EMA copies of ``models``, no grad
    opt_state: dict

    @classmethod
    def create(cls, models: dict[str, nn.Module], optimizer: AdamW) -> "TrainState":
        ema = {k: copy.deepcopy(m).requires_grad_(False) for k, m in models.items()}
        return cls(step=0, models=models, ema=ema, opt_state=optimizer.init(module_params(models)))

    def params(self) -> list[torch.Tensor]:
        return module_params(self.models)

    def ema_params(self) -> list[torch.Tensor]:
        return module_params(self.ema)
