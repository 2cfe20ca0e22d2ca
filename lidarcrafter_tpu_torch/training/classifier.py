"""PointMLP foreground-object classifier trainer (the CGF backbone).

Port of the JAX package's ``training/classifier.py``: label-smoothed
cross-entropy, weight decay then SGD with momentum on a cosine-decayed LR,
and a train step that updates the BatchNorms' running statistics as flax
does (``models/batch_norm.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..metrics.extractor.pointmlp import PointMLP
from .optim import SGD, cosine_decay_schedule


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, eps: float = 0.2) -> torch.Tensor:
    """Cross-entropy against one-hot labels smoothed over the other classes
    by eps / (n − 1)."""
    n_class = logits.shape[-1]
    one_hot = F.one_hot(labels.long(), n_class).to(logits.dtype)
    one_hot = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
    return -(one_hot * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def make_classifier_optimizer(lr: float = 0.1, min_lr: float = 0.005, epochs: int = 300, steps_per_epoch: int = 1,
                              momentum: float = 0.9, weight_decay: float = 2e-4) -> SGD:
    """Weight decay, then SGD with momentum on a cosine decay from ``lr`` to
    ``min_lr`` over ``epochs · steps_per_epoch`` updates."""
    return SGD(cosine_decay_schedule(lr, epochs * steps_per_epoch, alpha=min_lr / lr), momentum=momentum,
               weight_decay=weight_decay)


def make_classifier_train_step(model: PointMLP, tx: SGD):
    """``step(opt_state, batch, generator=None) -> (loss, acc)`` (tensors);
    ``batch``: {points (B, N, 3), labels (B,)}; ``generator`` draws the
    head's dropout.  The parameters, the running statistics and
    ``opt_state`` (``tx.init(list(model.parameters()))``) change in place."""
    params = list(model.parameters())

    def step(opt_state: dict, batch: dict, generator: torch.Generator | None = None):
        logits = model(batch["points"], train=True, generator=generator)
        loss = smoothed_cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(loss, params)
        tx.update_(params, list(grads), opt_state)
        acc = (logits.detach().argmax(dim=-1) == batch["labels"]).float().mean()
        return loss.detach(), acc

    return step


@torch.inference_mode()
def classifier_eval_step(model: PointMLP, points: torch.Tensor) -> torch.Tensor:
    """Logits on the running statistics."""
    return model(points)
