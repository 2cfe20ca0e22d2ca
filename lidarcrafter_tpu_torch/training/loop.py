"""The training loop.

Port of the JAX package's ``training/loop.py::Trainer`` for the
unconditional (``nuscenes-unet-uncond``) and the concat-conditioned layout
configs (``nuscenes-box-layout-v6``, ``nuscenes-auto-reg-v2``): factory →
AdamW → train step → EMA → periodic checkpoints → resume.  The host reads
the loss only when it logs.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from .. import resolve_device
from ..weights import init_random_
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .factory import build_diffusion_training
from .optim import cosine_warmup_schedule, make_optimizer
from .preprocess import preprocess_autoregressive_cond, preprocess_condition_mask, preprocess_x0
from .state import TrainState
from .train_step import make_train_step


class Trainer:
    """Unconditional / concat-conditioned diffusion trainer on ``device``.

    ``data_iter`` yields collated batches (numpy arrays or tensors) of raw
    ``depth`` / ``reflectance`` (and the layout conditions), which
    :meth:`prepare_batch` turns into the engine's input; a batch that
    carries ``x_0`` is in the engine's format already (the synthetic
    source) and is only moved to the device.
    """

    def __init__(
        self,
        cfg,
        data_iter: Iterator[dict],
        output_dir: str | Path | None = None,
        log_fn: Callable[[dict], None] | None = print,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.data_iter = data_iter
        self.log_fn = log_fn
        self.device = resolve_device(device)
        self.output_dir = Path(output_dir or cfg.training.output_dir)
        models, self.engine, self.lidar_utils = build_diffusion_training(cfg, self.device)
        self.is_cond = isinstance(models, dict)
        self.models = models if self.is_cond else {"model": models}
        t = cfg.training
        self.lr_schedule = cosine_warmup_schedule(t.lr, t.lr_warmup_steps, t.num_steps)
        self.optimizer = make_optimizer(
            lr=t.lr, warmup_steps=t.lr_warmup_steps, num_steps=t.num_steps, b1=t.adam_beta1,
            b2=t.adam_beta2, eps=t.adam_epsilon, weight_decay=t.adam_weight_decay,
            grad_accum_steps=t.gradient_accumulation_steps,
        )
        self.step_fn = make_train_step(
            self.engine, self.optimizer, ema_beta=t.ema_decay, ema_update_every=t.ema_update_every,
            ema_update_after_step=t.lr_warmup_steps * t.gradient_accumulation_steps,
            amp=t.mixed_precision == "bf16",
        )

    def init_state(self, seed: int) -> TrainState:
        """Fresh state: seeded random weights as the serving entry points
        draw them (``weights.init_random_``; encoder ``seed``, denoiser
        ``seed + 1``), EMA copies and a zero optimizer state."""
        if self.is_cond:
            init_random_(self.models["cond"], seed)
        init_random_(self.models["model"], seed + int(self.is_cond))
        return TrainState.create(self.models, self.optimizer)

    def prepare_batch(self, batch: dict):
        """Collated batch → engine input on the device."""
        tb = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
        if "x_0" in tb:
            return tb if self.is_cond else tb["x_0"]
        data = self.cfg.data
        x_0 = preprocess_x0(tb, self.lidar_utils, data.train_depth, data.train_reflectance)
        if not self.is_cond:
            return x_0
        input_dict = dict(tb, x_0=x_0)
        if "condition_mask" in tb:
            input_dict["concat_cond"] = preprocess_condition_mask(tb, self.lidar_utils, len(data.class_names))
        if "autoregressive_cond" in tb:
            input_dict["autoregressive_cond"] = preprocess_autoregressive_cond(
                tb["autoregressive_cond"], self.lidar_utils, include_reflectance=False
            )
        return input_dict

    def resume_state(self, resume: str, seed: int) -> TrainState:
        """The state of the checkpoint ``resume`` (weights, EMA, optimizer,
        step); ``'auto'`` takes the newest ``ckpt_*`` in ``output_dir``, or a
        fresh state when there is none."""
        path = latest_checkpoint(self.output_dir) if resume == "auto" else resume
        state = self.init_state(seed)
        if path is None:
            self._log({"resume": "no checkpoint found, fresh start"})
            return state
        state, _ = restore_checkpoint(path, state)
        self._log({"resume": str(path), "step": state.step})
        return state

    def _log(self, record: dict) -> None:
        if self.log_fn is not None:
            self.log_fn(record)

    def train(
        self,
        num_steps: int | None = None,
        seed: int | None = None,
        state: TrainState | None = None,
        checkpoint_every: int | None = None,
        log_every: int = 50,
        resume: str | None = None,
    ) -> TrainState:
        """Train until ``state.step`` reaches ``num_steps``; log every
        ``log_every`` steps (and steps 1 and 2), checkpoint every
        ``checkpoint_every`` to ``output_dir/ckpt_{step:010d}``."""
        seed = self.cfg.training.seed if seed is None else seed
        num_steps = num_steps or self.cfg.training.num_steps
        checkpoint_every = checkpoint_every or self.cfg.training.steps_save_model
        if state is None:
            state = self.resume_state(resume, seed) if resume else self.init_state(seed)
        t0, since = time.perf_counter(), state.step
        while state.step < num_steps:
            state, loss = self.step_fn(state, self.prepare_batch(next(self.data_iter)), seed)
            step = state.step
            if step % log_every == 0 or step <= 2:
                loss_value = float(loss)  # the host's only read of the device
                now = time.perf_counter()
                self._log({"step": step, "loss": loss_value, "lr": self.lr_schedule(step),
                           "sec_per_step": (now - t0) / max(1, step - since)})
                t0, since = now, step
            if checkpoint_every and step % checkpoint_every == 0:
                save_checkpoint(self.output_dir / f"ckpt_{step:010d}", state, self.cfg)
        return state
