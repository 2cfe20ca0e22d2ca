"""RangeNet semantic-segmentation trainer pieces.

Port of the JAX package's ``training/segmentation.py``: class-weighted
cross-entropy over range-image pixels with an ignored label, mean IoU, and
SGD with momentum and weight decay on a warmup / exponential-decay LR.
Logits are (B, C, H, W), as the port's RangeNet gives them (the JAX
package's are NHWC).

The JAX RangeNet keeps its BatchNorm statistics among its parameters and
reads them without updating them, so its trainer differentiates and
updates them like any weight; :func:`train_frozen_statistics_` makes the
port's do the same.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.extractor.pointnet import FrozenBN
from .optim import SGD
from .state import module_params


def trained_tensors(module: nn.Module) -> list[torch.Tensor]:
    """The parameters, then the buffers that require grad (the trained
    statistics), in ``training/state.py::module_params``'s order."""
    return module_params({"model": module})


def weighted_pixel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 class_weights: torch.Tensor | None = None, ignore_index: int = -1) -> torch.Tensor:
    """(B, C, H, W) logits × (B, H, W) int labels → the weighted mean NLL
    over the pixels whose label is not ``ignore_index``."""
    C = logits.shape[1]
    valid = labels != ignore_index
    safe = torch.clamp(labels.long(), 0, C - 1)
    logp = F.log_softmax(logits, dim=1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    w = class_weights[safe] if class_weights is not None else torch.ones_like(nll)
    w = w * valid
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def mean_iou(logits: torch.Tensor, labels: torch.Tensor, num_classes: int, ignore_index: int = -1) -> torch.Tensor:
    """Mean IoU over the classes present in the prediction or the labels
    (a class with an empty union is NaN and left out of the mean)."""
    pred = logits.argmax(dim=1)
    valid = labels != ignore_index
    ious = []
    for c in range(num_classes):
        p = (pred == c) & valid
        t = (labels == c) & valid
        inter = (p & t).sum()
        union = (p | t).sum()
        ious.append(torch.where(union > 0, inter / torch.clamp(union, min=1), torch.nan))
    return torch.nanmean(torch.stack(ious))


def train_frozen_statistics_(module: nn.Module) -> None:
    """Make the running statistics of every ``FrozenBN`` in ``module``
    trained tensors, as the JAX RangeNet's are."""
    for m in module.modules():
        if isinstance(m, FrozenBN):
            m.running_mean.requires_grad_(True)
            m.running_var.requires_grad_(True)


def make_segmentation_train_step(model: nn.Module, tx: SGD, class_weights: torch.Tensor | None = None,
                                 ignore_index: int = -1) -> Callable:
    """``step(opt_state, batch) -> loss``; ``batch`` = {'image' (B, Cin, H,
    W), 'labels' (B, H, W)}; ``opt_state`` is ``tx.init(trained_tensors(
    model))``, and it and the trained tensors change in place."""
    params = trained_tensors(model)

    def step(opt_state: dict, batch: dict) -> torch.Tensor:
        loss = weighted_pixel_cross_entropy(model(batch["image"]), batch["labels"], class_weights, ignore_index)
        grads = torch.autograd.grad(loss, params)
        tx.update_(params, list(grads), opt_state)
        return loss.detach()

    return step


def rangenet_class_weights(num_class: int = 17, epsilon_w: float = 0.001) -> torch.Tensor:
    """Inverse-frequency weights of a uniform content prior, the void class
    0 at zero."""
    content = torch.full((num_class,), 1.0 / (num_class - 1))
    w = 1.0 / (content + epsilon_w)
    w[0] = 0.0
    return w


def warmup_exp_decay_schedule(lr: float, warmup_steps: int, decay: float) -> Callable[[int], float]:
    """0 → ``lr`` linearly over ``warmup_steps`` updates, then × ``decay``
    per update."""
    warmup_steps = max(warmup_steps, 1)

    def sched(step: int) -> float:
        return lr * min(step / warmup_steps, 1.0) * decay ** max(step - warmup_steps, 0.0)

    return sched


def make_rangenet_optimizer(lr: float = 0.01, momentum: float = 0.9, weight_decay: float = 1e-4,
                            warmup_steps: int = 1000, decay: float = 0.9995) -> SGD:
    """Weight decay, then SGD with momentum on the warmup / decay LR."""
    return SGD(warmup_exp_decay_schedule(lr, warmup_steps, decay), momentum=momentum, weight_decay=weight_decay)
